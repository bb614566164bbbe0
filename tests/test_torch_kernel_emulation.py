"""The attention kernels' CUDA sources, run on the CPU.

This machine has no nvcc and no card: ``chip_smoke.py`` runs the kernels
on the H100. Here the sources of ``mxnet_tpu_torch/parallel/csrc``
themselves are compiled by g++ against ``tests/kernel_emu/emu.h``, which
runs each CUDA thread of a block as a std::thread and emulates the warp's
shuffles and ``mma.sync`` TF32 products (inline PTX, ``cp.async`` and the
``<<<...>>>`` launches are rewritten into its calls; the arithmetic, the
fragment layouts, the masks, the staging indices and the merges of
partial softmax states are the sources' own).

``flash_fwd.cu``: every block shape (S = 1 or 4 warps on a row group, and
the host's choice) is held to the port's plain version (O and LSE, within
chip_smoke.py's TOL for the kernel on the card; the emulated tensor cores
sum in IEEE order, the card's round toward zero) and O to the JAX
package's ``_jnp_reference``; rows with no live key must carry the plain
version's LSE, and two calls must be bit-identical.

``flash_decode.cu`` and ``flash_decode_q8.cu`` (a row's splits one
cluster of blocks, run at once, which merge through each other's shared
memory): at B3 H2 with T split
unevenly into chunks, D 7, 8, 64 and 128, and lengths of 1, one chunk, one
chunk + 1 and T, on the host's split of the cache and on forced ones
(one split a row; more splits than chunks), each held to the port's plain
version and to JAX's ``_jnp_decode`` (rtol = atol = 1e-5); a row of
length 0 must get o = 0; garbage and NaN past each length (K and V, and
the int8 kernel's scales) must leave the output bit-identical, two calls
must be bit-identical, and the int8 kernel must equal the fp32 kernel on
the dequantized cache bit for bit. The host's choice of splits is
checked at small and large B * H.

``nms_sweep.cu`` (the greedy NMS keep mask: a bit-mask pass, then one
block a sample sweeping it): at n = 1, 63, 64, 65 and 300, in both IoU
conventions, with and without a class gate, over boxes with exact
duplicates and pairs at the threshold, its keep mask equal bit for bit
to the port's ``nms_keep_plain`` and to the JAX package's ``_nms_mask``
(corner IoU, scores with ties through the stable sort) and
``_greedy_nms_keep`` (+1 IoU); two calls bit-identical."""
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


def _emulated_sources(out, name):
    """flash_common.cuh and kernel ``name``'s source rewritten for emu.h
    into ``out``; returns the path of the kernel's C++ file."""
    with open(os.path.join(_build._CSRC, "flash_common.cuh")) as f:
        common = f.read().replace("#include <cuda_runtime.h>",
                                  '#include "emu.h"')
    for signature, body in (
            ("void cp_async4(",
             "  if (pred) std::memcpy(dst, src, 4);\n"
             "  else std::memset(dst, 0, 4);"),
            ("void cp_async16(",
             "  if (pred) std::memcpy(dst, src, 16);\n"
             "  else std::memset(dst, 0, 16);"),
            ("void cp_async_commit(", ""),
            ("void cp_async_wait(", ""),
            ("void cluster_sync(", "  emu_cluster_sync();"),
            ("const float* peer(", "  return emu_peer(p, rank);"),
            ("cudaError_t launch_clusters(",
             "  emu_launch_cluster(kernel, grid, cluster, block, smem,"
             " args...);\n  return cudaSuccess;"),
            ("void mma_tf32(", "  emu_mma(d, a, b);")):
        common = _replace_body(common, signature, body)
    with open(os.path.join(out, "flash_common.cuh"), "w") as f:
        f.write(common)
    with open(os.path.join(_build._CSRC, _build.SOURCES[name])) as f:
        src = f.read()
    src = src.replace("extern __shared__ float4 smem4[];",
                      "float4* smem4 = emu_smem;")
    # kernel<<<grid, block, smem, stream>>>(args) -> emu_launch(kernel,
    # grid, block, smem, args)
    src = re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(",
                 lambda m: "emu_launch(%s, %s, " % (
                     m.group(1), ",".join(m.group(2).split(",")[:3])),
                 src, flags=re.S)
    path = os.path.join(out, name + ".cpp")
    with open(path, "w") as f:
        f.write(src)
    return path


def _emulated_library(tmp_path_factory, name):
    """Kernel ``name``'s source built by g++ under emu.h, loaded."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the kernel emulation")
    out = str(tmp_path_factory.mktemp(name + "_emu"))
    cpp = _emulated_sources(out, name)
    lib = os.path.join(out, "lib%s_emu.so" % name)
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O2", "-fno-strict-aliasing", "-shared",
         "-fPIC", "-pthread", "-w", "-I", out, "-I", EMU, "-o", lib, cpp],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(lib)


@pytest.fixture(scope="module")
def fwd_lib(tmp_path_factory):
    """The emulated kernel's library: its ``mxt_flash_fwd_split``,
    which forces the block shape, and ``mxt_flash_fwd``, declared as the
    port declares the card's, with the kernel's own choice."""
    dll = _emulated_library(tmp_path_factory, "flash_fwd")
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


# --- the decode pair -------------------------------------------------------

DEC_TOL = dict(rtol=1e-5, atol=1e-5)
DEC_CASES = {
    # name: (B, T, H, D); T splits into chunks of uneven length
    "D7_T301": (3, 301, 2, 7),       # 4-byte fp32 copies, int8 bytes
    "D8_T301": (3, 301, 2, 8),       # 16-byte fp32 copies, int8 words
    "D64_T101": (3, 101, 2, 64),     # the model's width: int8 int4s
    "D128_T101": (3, 101, 2, 128),
}
# the three rows' lengths: 1, one chunk, one chunk + 1, T
DEC_LENGTHS = {"short": lambda T, c: [1, c, c + 1],
               "full": lambda T, c: [T, c + 1, 1]}


def _chunk(T, S):
    """A split's positions (``decode::chunk_keys``): T cut into S parts."""
    return -(-max(T, 1) // S)


@pytest.fixture(scope="module")
def decode_libs(tmp_path_factory):
    """The two decode kernels' emulated entry points, declared as the port
    declares the card's (with ``.splits``, the host's choice)."""
    return {name: _build._declare(_emulated_library(tmp_path_factory, name),
                                  name)
            for name in ("flash_decode", "flash_decode_q8")}


def _decode(fn, q, k, v, lens, scale, S=None, ks=None, vs=None):
    """(o, S) of one call at S splits, by default the host's (the entry
    point's own choice, as the port calls it); the int8 kernel when
    ``ks`` is given. The output starts as NaNs."""
    B, _, H, D = q.shape
    T = k.shape[1]
    o = np.full_like(q, np.nan)
    scales = () if ks is None else (ks.ctypes.data, vs.ctypes.data)
    rc = fn(q.ctypes.data, k.ctypes.data, v.ctypes.data, *scales,
            lens.ctypes.data, o.ctypes.data, B, H, T, D, scale,
            0 if S is None else S, None)
    assert rc == 0
    return o, fn.splits(B, H, T, D) if S is None else S


def _decode_inputs(B, T, H, D, seed):
    """fp32 q, K, V and int8 K, V with (B, T) scales, as
    tests/test_kv_int8.py makes them."""
    rs = np.random.RandomState(seed)
    q = rs.randn(B, 1, H, D).astype(np.float32)
    k, v = (rs.randn(B, T, H, D).astype(np.float32) for _ in range(2))
    k8, v8 = (rs.randint(-127, 128, size=(B, T, H, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (rs.uniform(0.005, 0.02, size=(B, T)).astype(np.float32)
              for _ in range(2))
    return q, k, v, k8, v8, ks, vs


def _garbage_tail(lens, seed, *arrays):
    """Copies of (B, T, ...) arrays with every position at or beyond its
    row's length overwritten: NaN in float arrays, random bytes in int8."""
    rs = np.random.RandomState(seed)
    out = []
    for a in arrays:
        a = a.copy()
        for b, n in enumerate(lens):
            if a.dtype == np.int8:
                a[b, n:] = rs.randint(-128, 128, size=a[b, n:].shape)
            else:
                a[b, n:] = np.nan
        out.append(a)
    return out


def _hold_decode(fns, q, k, v, k8, v8, ks, vs, lens, S=None):
    """Both kernels on one input, with every check of the module's
    docstring; returns the splits the call used."""
    scale = q.shape[-1] ** -0.5
    fp32, q8 = fns["flash_decode"], fns["flash_decode_q8"]
    # a row with no live key: the kernels write 0, where the plain version
    # and JAX average V over the whole (garbage) cache
    live = lens > 0
    o, S = _decode(fp32, q, k, v, lens, scale, S)
    np.testing.assert_array_equal(o[~live], 0.0)
    np.testing.assert_array_equal(_decode(fp32, q, k, v, lens, scale, S)[0],
                                  o)
    want = tfa._torch_decode(*(torch.from_numpy(x) for x in (q, k, v)),
                             torch.from_numpy(lens), scale).numpy()
    np.testing.assert_allclose(o[live], want[live], **DEC_TOL)
    ref = np.asarray(jfa._jnp_decode(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(lens),
                                     scale))
    np.testing.assert_allclose(o[live], ref[live], **DEC_TOL)
    gk, gv = _garbage_tail(lens, 1, k, v)
    np.testing.assert_array_equal(_decode(fp32, q, gk, gv, lens, scale, S)[0],
                                  o)

    o8, _ = _decode(q8, q, k8, v8, lens, scale, S, ks, vs)
    np.testing.assert_array_equal(
        _decode(q8, q, k8, v8, lens, scale, S, ks, vs)[0], o8)
    want8 = tfa._torch_decode_q8(
        *(torch.from_numpy(x) for x in (q, k8, v8, ks, vs, lens)),
        scale).numpy()
    np.testing.assert_allclose(o8[live], want8[live], **DEC_TOL)
    ref8 = np.asarray(jfa.flash_decode(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(lens),
        scale=scale, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    np.testing.assert_allclose(o8[live], ref8[live], **DEC_TOL)
    # the fp32 kernel on the dequantized cache: one fp32 multiply an element
    kd = k8.astype(np.float32) * ks[:, :, None, None]
    vd = v8.astype(np.float32) * vs[:, :, None, None]
    np.testing.assert_array_equal(_decode(fp32, q, kd, vd, lens, scale, S)[0],
                                  o8)
    gk8, gv8, gks, gvs = _garbage_tail(lens, 2, k8, v8, ks, vs)
    np.testing.assert_array_equal(
        _decode(q8, q, gk8, gv8, lens, scale, S, gks, gvs)[0], o8)
    return S


@pytest.mark.parametrize("lengths", sorted(DEC_LENGTHS))
@pytest.mark.parametrize("name", sorted(DEC_CASES))
def test_decode_sources_match_plain_and_jax(decode_libs, name, lengths):
    """The host's split: more than one chunk a row, the last one short."""
    B, T, H, D = DEC_CASES[name]
    S = decode_libs["flash_decode"].splits(B, H, T, D)
    chunk = _chunk(T, S)
    assert S == -(-T // chunk) > 1 and T % chunk
    assert decode_libs["flash_decode_q8"].splits(B, H, T, D) == S
    lens = np.array(DEC_LENGTHS[lengths](T, chunk), np.int32)
    data = _decode_inputs(B, T, H, D, seed=len(name) + len(lengths))
    assert _hold_decode(decode_libs, *data, lens) == S


@pytest.mark.parametrize("splits", [1, 8])
def test_decode_sources_at_forced_splits(decode_libs, splits):
    """One split a row (each block writes o itself, as at a large B * H),
    and the most, 8 (the host takes 4 here); a row of length 0 among
    them, and one whose last four splits are empty."""
    B, T, H, D = 3, 100, 2, 64
    lens = np.array([0, 40, T], np.int32)
    data = _decode_inputs(B, T, H, D, seed=splits)
    assert _hold_decode(decode_libs, *data, lens, S=splits) == splits


@pytest.mark.parametrize("shape,want", [
    ((3, 2, 100, 64), 4),         # small B * H: as many as the stages allow
    ((1, 12, 576, 64), 8),        # one stream of the server: the most
    ((8, 12, 576, 64), 6),        # the server's window: 576 blocks
    ((8, 12, 576, 128), 6),
    ((44, 12, 576, 64), 1),       # 528 rows fill 4 blocks an SM alone
    ((64, 12, 1024, 64), 1),
    ((8, 12, 20, 64), 1),         # one stage
    ((1, 2, 1024, 128), 8),       # at most kMaxSplits, one cluster
])
def test_decode_host_splits(decode_libs, shape, want):
    """``decode::pick_splits`` on the emulator's 132 SMs, the same for
    both kernels."""
    for fn in decode_libs.values():
        assert fn.splits(*shape) == want


# --- the NMS sweep -----------------------------------------------------------

jdet = importlib.import_module("mxnet_tpu.ops.detection")
jdef = importlib.import_module("mxnet_tpu.ops.deformable")
tdet = importlib.import_module("mxnet_tpu_torch.ops.detection")


@pytest.fixture(scope="module")
def nms_lib(tmp_path_factory):
    """``nms_sweep.cu`` built by g++ under emu.h (its cp.async copies done
    at once), declared as the port declares the card's."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the kernel emulation")
    out = str(tmp_path_factory.mktemp("nms_sweep_emu"))
    with open(os.path.join(_build._CSRC, _build.SOURCES["nms_sweep"])) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    src = src.replace("extern __shared__ float4 smem4[];",
                      "float4* smem4 = emu_smem;")
    for signature, body in (
            ("void cp_async_words(", "  std::memcpy(dst, src, 8 * kCopyWords);"),
            ("void cp_async_commit(", ""),
            ("void cp_async_wait_stages(", "")):
        src = _replace_body(src, signature, body)
    src = re.sub(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(",
                 lambda m: "emu_launch(%s, %s, " % (
                     m.group(1), ",".join(m.group(2).split(",")[:3])),
                 src, flags=re.S)
    cpp = os.path.join(out, "nms_sweep.cpp")
    with open(cpp, "w") as f:
        f.write(src)
    lib = os.path.join(out, "libnms_sweep_emu.so")
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O2", "-fno-strict-aliasing", "-shared",
         "-fPIC", "-pthread", "-w", "-I", EMU, "-o", lib, cpp],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return _build._declare(ctypes.CDLL(lib), "nms_sweep")


def test_nms_short_chain_limit_is_the_kernels():
    """``NMS_SHORT_CHAIN`` (what chip_smoke.py reports chains against) is
    the source's kShortMax."""
    with open(os.path.join(_build._CSRC, _build.SOURCES["nms_sweep"])) as f:
        limit = re.search(r"constexpr int kShortMax = (\d+);", f.read())
    assert int(limit.group(1)) == tdet.NMS_SHORT_CHAIN


def _sweep(fn, boxes, thresh, cls=None, plus_one=False):
    """The emulated kernel's keep mask (B, n) over sorted ``boxes``,
    through the port's own glue (``_nms_order``, ``_nms_launch``) in a
    workspace of garbage and into a keep mask of 7s (each entry must be
    written)."""
    B, n = boxes.shape[:2]
    boxes = torch.from_numpy(np.ascontiguousarray(boxes, np.float32))
    cls = None if cls is None else torch.from_numpy(
        np.ascontiguousarray(cls, np.float32))
    size = fn.workspace(B, n)
    assert size > 0
    work = torch.full((size,), 0xAB, dtype=torch.uint8)
    keep = torch.full((B, n), 7, dtype=torch.uint8)
    tdet._nms_launch(fn, boxes, thresh, cls, tdet._nms_order(cls),
                     plus_one, work, keep.view(torch.bool))
    assert set(np.unique(keep.numpy())) <= {0, 1}
    return keep.numpy().astype(bool)


def _nms_boxes(B, n, seed, plus_one):
    """Clustered boxes (many overlaps), with exact duplicates and pairs
    whose IoU is exactly 0.5 (corner) in each sample."""
    rs = np.random.RandomState(seed)
    span, size = (100.0, 30.0) if plus_one else (1.0, 0.3)
    ctr = rs.uniform(0, span, (B, n, 2)).astype(np.float32)
    wh = rs.uniform(0.05 * size, size, (B, n, 2)).astype(np.float32)
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    if plus_one:
        boxes = np.round(boxes)
        boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2])
    if n >= 4:
        boxes[:, n // 2] = boxes[:, 1]                       # a duplicate
        boxes[:, 2] = [0.0, 0.0, 4.0, 1.0]
        boxes[:, 3] = [0.0, 0.0, 2.0, 1.0]                   # IoU 0.5
    return boxes.astype(np.float32)


@pytest.mark.parametrize("classes", [False, True])
@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("n", [1, 63, 64, 65, 300])
def test_nms_sweep_source_matches_plain_and_jax(nms_lib, n, plus_one,
                                                classes):
    B = 2
    boxes = _nms_boxes(B, n, seed=n + 7 * plus_one, plus_one=plus_one)
    cls = np.random.RandomState(n).randint(0, 3, (B, n)).astype(
        np.float32) if classes else None
    for thresh in (0.5, 0.3):
        got = _sweep(nms_lib, boxes, thresh, cls, plus_one)
        np.testing.assert_array_equal(
            _sweep(nms_lib, boxes, thresh, cls, plus_one), got)
        plain = tdet.nms_keep_plain(
            torch.from_numpy(boxes), thresh,
            None if cls is None else torch.from_numpy(cls), plus_one)
        np.testing.assert_array_equal(got, plain.numpy())
        for b in range(B):
            if plus_one and not classes:
                want = jdef._greedy_nms_keep(jnp.asarray(boxes[b]), thresh)
            elif plus_one:
                continue              # the JAX package gates no +1 NMS
            else:
                want = jdet._nms_mask(
                    jnp.asarray(boxes[b]), -jnp.arange(n, dtype=jnp.float32),
                    thresh, None if cls is None else jnp.asarray(cls[b]))
            np.testing.assert_array_equal(got[b], np.asarray(want))
    if n >= 4:                  # a kept box's duplicate in its class goes
        same = True if cls is None else cls[:, 1] == cls[:, n // 2]
        assert not (got[:, 1] & got[:, n // 2] & same).any()


@pytest.mark.parametrize("n", [65, 300])
def test_nms_sweep_with_tied_scores_matches_jax(nms_lib, n):
    """Scores with ties: the port's stable sort, the emulated sweep and
    the mask put back in input order, against the JAX package's
    ``_nms_mask`` on the unsorted boxes."""
    boxes = _nms_boxes(1, n, seed=3 * n, plus_one=False)[0]
    rs = np.random.RandomState(n)
    scores = rs.randint(0, 8, n).astype(np.float32)        # many ties
    cls = rs.randint(0, 2, n).astype(np.float32)
    order = torch.argsort(-torch.from_numpy(scores), stable=True).numpy()
    keep_sorted = _sweep(nms_lib, boxes[order][None], 0.45,
                         cls[order][None])[0]
    got = np.empty(n, bool)
    got[order] = keep_sorted
    want = jdet._nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.45,
                          jnp.asarray(cls))
    np.testing.assert_array_equal(got, np.asarray(want))
    port = tdet._nms_mask(torch.from_numpy(boxes)[None],
                          torch.from_numpy(scores)[None], 0.45,
                          torch.from_numpy(cls)[None])
    np.testing.assert_array_equal(port[0].numpy(), got)


# the class gates of the chain cases: none, one id for every box, 2 or 20
# ids drawn at random (interleaved in score order), 20 ids with a group of
# -1 (60% of the boxes: a long chain at n = 1000 beside short ones), and
# odd ids (0.0 beside -0.0, NaN, -1)
NMS_GATES = ("none", "one", "two", "twenty", "neg1", "odd")


def _nms_ids(gate, B, n, seed):
    rs = np.random.RandomState(seed)
    if gate == "none":
        return None
    if gate == "one":
        return np.full((B, n), 4.0, np.float32)
    if gate in ("two", "twenty"):
        return rs.randint(0, 2 if gate == "two" else 20, (B, n)).astype(
            np.float32)
    if gate == "neg1":
        ids = rs.randint(0, 20, (B, n)).astype(np.float32)
        ids[:, rs.rand(n) < 0.6] = -1.0
        return ids
    return rs.choice(np.array([0.0, -0.0, 1.0, np.nan, -1.0], np.float32),
                     (B, n))


def _nms_case_boxes(B, n, seed, plus_one):
    """``_nms_boxes`` with, for the +1 IoU, a pair at exactly 0.5 too."""
    boxes = _nms_boxes(B, n, seed, plus_one)
    if plus_one and n >= 6:
        boxes[:, 4] = [0.0, 0.0, 3.0, 0.0]
        boxes[:, 5] = [0.0, 0.0, 1.0, 0.0]          # +1 IoU 2 / 4
    return boxes


def _apart(boxes, ids):
    """Integer +1 boxes with each class moved 4096 a class along x (exact:
    the coordinates stay integers under 2^24), so no two classes meet and
    the ungated +1 chain of the JAX package is the gated one; a NaN id is a
    class of its own, -0 is 0."""
    key = ids + np.float32(0.0)
    uniq = {v: i for i, v in enumerate(np.unique(key[~np.isnan(key)]))}
    slot = np.array([uniq[v] if not np.isnan(v) else len(uniq) + k
                     for k, v in enumerate(key)], np.float32)
    out = boxes.copy()
    out[:, 0] += 4096 * slot
    out[:, 2] += 4096 * slot
    return out


def _nms_jax(boxes, thresh, ids, plus_one):
    """The JAX package's keep mask of one sample's sorted boxes: ``_nms_mask``
    (corner IoU, its own gate) or ``_greedy_nms_keep`` (+1 IoU, the gate by
    ``_apart``)."""
    n = boxes.shape[0]
    if plus_one:
        b = boxes if ids is None else _apart(boxes, ids)
        return np.asarray(jdef._greedy_nms_keep(jnp.asarray(b), thresh))
    return np.asarray(jdet._nms_mask(
        jnp.asarray(boxes), -jnp.arange(n, dtype=jnp.float32), thresh,
        None if ids is None else jnp.asarray(ids)))


# (n, gate): every gate at the short sizes; the long chains at n = 1000
NMS_CHAIN_CASES = [(n, gate) for n in (63, 64, 65, 127, 128, 129, 300)
                   for gate in NMS_GATES] + [
    (1000, gate) for gate in ("none", "one", "twenty", "neg1")]


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("n,gate", NMS_CHAIN_CASES)
def test_nms_sweep_chains_match_plain_and_jax(nms_lib, n, gate, plus_one):
    """Each gate's chains (short ones in a block's shared memory, long ones
    through the card-wide mask at n = 1000), through the port's class order
    and the kernel's scatter back, bit-equal to ``nms_keep_plain`` and to
    the JAX package at thresh 0.5 (the pairs at exactly 0.5 stay) and 0
    (any overlap suppresses); two calls bit-identical."""
    B = 2
    boxes = _nms_case_boxes(B, n, seed=n + 11 * plus_one, plus_one=plus_one)
    ids = _nms_ids(gate, B, n, seed=n + NMS_GATES.index(gate))
    for thresh in (0.5, 0.0):
        got = _sweep(nms_lib, boxes, thresh, ids, plus_one)
        if thresh == 0.5:
            np.testing.assert_array_equal(
                _sweep(nms_lib, boxes, thresh, ids, plus_one), got)
        plain = tdet.nms_keep_plain(
            torch.from_numpy(boxes), thresh,
            None if ids is None else torch.from_numpy(ids), plus_one)
        np.testing.assert_array_equal(got, plain.numpy())
        for b in range(B):
            np.testing.assert_array_equal(
                got[b], _nms_jax(boxes[b], thresh,
                                 None if ids is None else ids[b], plus_one))
    if gate == "none":      # a kept box's duplicate goes; 2 and 3 meet at 0.5
        assert not (got[:, 1] & got[:, n // 2]).any()


@pytest.mark.parametrize("plus_one", [False, True])
def test_nms_sweep_long_chain_in_column_slices(nms_lib, plus_one):
    """One chain of 4200 boxes: its last two mask words' columns (4160 and
    4200 rows) are longer than a sweep stage's 4096 rows, so each comes in
    two pieces; bit-equal to ``nms_keep_plain`` and to the JAX package."""
    n = 4200
    boxes = _nms_case_boxes(1, n, seed=42 + plus_one, plus_one=plus_one)
    got = _sweep(nms_lib, boxes, 0.5, None, plus_one)
    plain = tdet.nms_keep_plain(torch.from_numpy(boxes), 0.5, None, plus_one)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(got[0], _nms_jax(boxes[0], 0.5, None,
                                                   plus_one))


@pytest.mark.parametrize("plus_one", [False, True])
def test_nms_sweep_quotients_next_to_the_threshold(nms_lib, plus_one):
    """A pair whose IoU q lies near 0.5 (corner) or 0.75 (+1), at
    thresholds q, the float below and the float above, for 16 widths a few
    ulps apart: where the kernel's division-free tests hand over to the IEEE
    division. Bit-equal to ``nms_keep_plain`` and to the JAX package."""
    width = np.float32(0.5)
    for _ in range(8):
        width = np.nextafter(width, np.float32(1))
        top = np.float32(0.0 if plus_one else 1.0)
        boxes = np.array([[[0.0, 0.0, 1.0, top], [0.0, 0.0, width, top]]],
                         np.float32)
        t = torch.from_numpy(boxes)
        iou = (tdet._iou_plus_one if plus_one else tdet._iou_corner)(t, t)
        q = np.float32(iou[0, 0, 1])
        for thresh in (np.nextafter(q, np.float32(0)), q,
                       np.nextafter(q, np.float32(1))):
            got = _sweep(nms_lib, boxes, float(thresh), None, plus_one)
            plain = tdet.nms_keep_plain(t, float(thresh), None, plus_one)
            np.testing.assert_array_equal(got, plain.numpy())
            np.testing.assert_array_equal(
                got[0], _nms_jax(boxes[0], float(thresh), None, plus_one))
            assert got[0, 1] == (thresh >= q)
