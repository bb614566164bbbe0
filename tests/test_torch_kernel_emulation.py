"""The forward attention kernel's CUDA source, run on the CPU.

This machine has no nvcc and no card: ``chip_smoke.py`` runs the kernels
on the H100. Here ``mxnet_tpu_torch/parallel/csrc/flash_fwd.cu`` itself
is compiled by g++ against ``tests/kernel_emu/emu.h``, which runs each
CUDA thread of a block as a std::thread and emulates the warp's shuffles
and ``mma.sync`` TF32 products (inline PTX, ``cp.async`` and the
``<<<...>>>`` launches are rewritten into its calls; the arithmetic, the
fragment layouts, the masks, the staging indices and the merge of the
warps' partial softmax are the source's own). Every block shape (S = 1
or 4 warps on a row group, and the host's choice) is held to the port's
plain version (O and LSE, within chip_smoke.py's TOL for the kernel on
the card; the emulated tensor cores sum in IEEE order, the card's round
toward zero) and O to the JAX
package's ``_jnp_reference``; rows with no live key must carry the plain
version's LSE, and two calls must be bit-identical."""
import ctypes
import importlib
import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.parallel import _build

jfa = importlib.import_module("mxnet_tpu.parallel.flash_attention")
tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")

EMU = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernel_emu")
FWD_TOL = dict(rtol=1e-5, atol=1e-5)

CASES = {
    # name: (B, Tq, Tk, H, D, causal, segmented)
    "ragged_T100_D16": (1, 100, 100, 1, 16, True, False),
    "D30_Tq40_Tk72": (1, 40, 72, 1, 30, True, False),    # 4-byte staging
    "D128_Tq40_Tk24": (1, 40, 24, 1, 128, True, False),
    "cross_D64": (1, 24, 80, 1, 64, False, False),
    "packed_B2_T80": (2, 80, 80, 1, 64, True, True),
    "cross_D8_Tq70_Tk33": (1, 70, 33, 2, 8, False, False),
}


def _replace_body(text, signature, body):
    """``text`` with the body of the function whose definition starts with
    ``signature`` (and ends at the next line that is a lone ``}``)
    replaced by ``body``."""
    start = text.index("{", text.index(signature))
    end = text.index("\n}\n", start)
    return text[:start] + "{\n" + body + text[end:]


def _emulated_sources(out):
    """flash_common.cuh and flash_fwd.cu rewritten for emu.h into
    ``out``; returns the path of the kernel's C++ file."""
    with open(os.path.join(_build._CSRC, "flash_common.cuh")) as f:
        common = f.read().replace("#include <cuda_runtime.h>",
                                  '#include "emu.h"')
    for signature, body in (
            ("void cp_async4(", "  *dst = pred ? *src : 0.f;"),
            ("void cp_async_wait_all(", ""),
            ("void cp_async16(",
             "  for (int i = 0; i < 4; ++i) dst[i] = pred ? src[i] : 0.f;"),
            ("void cp_async_commit(", ""),
            ("void cp_async_wait(", ""),
            ("void mma_tf32(", "  emu_mma(d, a, b);")):
        common = _replace_body(common, signature, body)
    with open(os.path.join(out, "flash_common.cuh"), "w") as f:
        f.write(common)
    with open(os.path.join(_build._CSRC, "flash_fwd.cu")) as f:
        src = f.read()
    src = src.replace("extern __shared__ float4 smem4[];",
                      "float4* smem4 = emu_smem;")
    # kernel<<<grid, block, smem, stream>>>(args) -> emu_launch(kernel,
    # grid, block, smem, args)
    src = re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(",
                 lambda m: "emu_launch(%s, %s, " % (
                     m.group(1), ",".join(m.group(2).split(",")[:3])),
                 src, flags=re.S)
    path = os.path.join(out, "flash_fwd.cpp")
    with open(path, "w") as f:
        f.write(src)
    return path


@pytest.fixture(scope="module")
def fwd_lib(tmp_path_factory):
    """The emulated kernel's library: its ``mxt_flash_fwd_split``,
    which forces the block shape, and ``mxt_flash_fwd``, declared as the
    port declares the card's, with the kernel's own choice."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the kernel emulation")
    out = str(tmp_path_factory.mktemp("flash_fwd_emu"))
    cpp = _emulated_sources(out)
    lib = os.path.join(out, "libflash_fwd_emu.so")
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-w",
         "-I", out, "-I", EMU, "-o", lib, cpp],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    dll = ctypes.CDLL(lib)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.mxt_flash_fwd_split.argtypes = [p] * 6 + [i] * 5 + [f, i, i, p]
    dll.mxt_flash_fwd_split.restype = i
    return dll.mxt_flash_fwd_split, _build._declare(dll, "flash_fwd")


def _inputs(case, seed):
    B, Tq, Tk, H, D, causal, segmented = case
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Tq, H, D).astype(np.float32)
    k = rs.randn(B, Tk, H, D).astype(np.float32)
    v = rs.randn(B, Tk, H, D).astype(np.float32)
    seg = None
    if segmented:
        seg = np.zeros((B, Tq), np.int32)
        for b in range(B):
            cut = rs.randint(8, Tq // 2)
            seg[b, :cut] = 1
            seg[b, cut:Tq - 7 - b] = 2          # a pad tail of 7 + b
    return q, k, v, seg


def _run(fn, q, k, v, seg, scale, causal, *split):
    """(o, lse) of one call; ``split`` is the block-shape argument of
    ``mxt_flash_fwd_split``, absent for ``mxt_flash_fwd``."""
    B, Tq, H, D = q.shape
    o = np.full_like(q, np.nan)
    lse = np.full((B, H, Tq), np.nan, np.float32)
    rc = fn(q.ctypes.data, k.ctypes.data, v.ctypes.data,
            None if seg is None else seg.ctypes.data, o.ctypes.data,
            lse.ctypes.data, B, H, Tq, k.shape[1], D, scale, int(causal),
            *split, None)
    assert rc == 0
    return o, lse


@pytest.mark.parametrize("split", [0, 1, 4])
@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_fwd_source_matches_plain_and_jax(fwd_lib, name, split):
    case = CASES[name]
    causal = case[5]
    q, k, v, seg = _inputs(case, seed=len(name))
    scale = q.shape[-1] ** -0.5
    fwd_split, fwd = fwd_lib
    o, lse = _run(fwd_split, q, k, v, seg, scale, causal, split)
    # a second call, and for split 0 the entry point without the argument
    again = _run(fwd, q, k, v, seg, scale, causal) if split == 0 else \
        _run(fwd_split, q, k, v, seg, scale, causal, split)
    np.testing.assert_array_equal(again[0], o)
    np.testing.assert_array_equal(again[1], lse)
    want, want_lse = (x.numpy() for x in tfa._torch_fwd_lse(
        *(torch.from_numpy(x) for x in (q, k, v)),
        None if seg is None else torch.from_numpy(seg), scale, causal))
    rows = np.ones(q.shape[:2], bool) if seg is None else seg > 0
    np.testing.assert_allclose(o[rows], want[rows], **FWD_TOL)
    lse_rows = lse.transpose(0, 2, 1)
    want_rows = want_lse.transpose(0, 2, 1)
    np.testing.assert_allclose(lse_rows[rows], want_rows[rows], **FWD_TOL)
    # rows that attend to nothing: the plain version's LSE (-1e30), which
    # the backward's P recompute reads
    np.testing.assert_array_equal(lse_rows[~rows], want_rows[~rows])
    ref = np.asarray(jfa._jnp_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal,
        segment_ids=None if seg is None else jnp.asarray(seg)))
    np.testing.assert_allclose(o[rows], ref[rows], **FWD_TOL)
