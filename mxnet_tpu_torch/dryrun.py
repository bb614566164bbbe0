"""One training step of a toy transformer split over every mesh axis
(counterpart of ``__graft_entry__.py``'s ``_mesh_sizes`` and
``dryrun_multichip``).

The batch is split over ``dp``, the sequence over ``sp`` (ring
attention), the attention projections over ``tp`` (``wq``/``wk``/``wv``/
``wout`` column-parallel, ``wo`` row-parallel), the experts of a top-k
routed MoE over ``ep`` (= ``tp``) and a GPipe schedule of FFN stages over
``pp``. Each rank is one process of ``tools.launch`` and holds its shard
of every parameter; the weights are the JAX entry point's
(``RandomState(0)``, the same draws in the same order), cut into this
rank's pieces by their partition specs (:func:`shard_host`).

Gradient convention (``parallel.collectives``): each rank's loss holds
its tokens' share, and the gradients are summed over ``dp`` and ``sp``;
over ``tp`` and ``pp`` a replicated value carries its whole gradient on
every rank (Megatron-LM's identity/all-reduce operators at the entry and
exit of each split computation).

``python -m mxnet_tpu_torch.dryrun [N]`` runs :func:`dryrun_multichip`
(N = 8 by default) on ``cuda:0``, or on the CPU under
``MXNET_DEFAULT_CONTEXT=cpu``; ``MXNET_TPU_DRYRUN_DEGENERATE_AXIS=pp|tp``
picks the model axis left at size 1, as in the JAX entry point.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from .base import atomic_write_bytes

__all__ = ["mesh_sizes", "jax_dims", "init_host", "shard_host", "SPECS",
           "dryrun_step", "dryrun_multichip", "launch_runs"]

# the partition spec of every parameter and input (mesh axis per dim)
SPECS = {
    "wq": (None, "tp"), "wk": (None, "tp"), "wv": (None, "tp"),
    "wo": ("tp", None),
    "wg": (),                                   # the MoE router
    "w1": ("tp", None, None), "w2": ("tp", None, None),   # experts over ep
    "pw1": ("pp", None, None), "pw2": ("pp", None, None),  # stages over pp
    "wout": (None, "tp"),
    "x": ("dp", "sp", None), "y": ("dp", "sp", None),
}
PARAMS = ("wq", "wk", "wv", "wo", "wg", "w1", "w2", "pw1", "pw2", "wout")
LR = 0.01
AUX_WEIGHT = 0.01


def mesh_sizes(n, degenerate=None):
    """Factor ``n`` into ``{dp, pp, tp, sp}`` (``ep`` rides ``tp``): one
    factor of 2 to each axis in turn, ``dp`` first; at ``n = 8`` the
    model axis ``degenerate`` (``MXNET_TPU_DRYRUN_DEGENERATE_AXIS``,
    default ``pp``) stays 1. An odd remainder multiplies ``dp``."""
    if degenerate is None:
        degenerate = os.environ.get("MXNET_TPU_DRYRUN_DEGENERATE_AXIS", "pp")
    if degenerate not in ("pp", "tp"):
        raise ValueError("degenerate axis is pp or tp, not %r" % degenerate)
    order = {"pp": ("dp", "tp", "sp", "pp"),
             "tp": ("dp", "pp", "sp", "tp")}[degenerate]
    sizes = {"dp": 1, "pp": 1, "tp": 1, "sp": 1}
    rem = n
    for ax in order:
        if rem % 2 == 0 and rem > 1:
            sizes[ax] = 2
            rem //= 2
    sizes["dp"] *= rem
    total = sizes["dp"] * sizes["pp"] * sizes["tp"] * sizes["sp"]
    if total != n:
        raise ValueError("mesh %s product %d != %d" % (sizes, total, n))
    return sizes


def jax_dims(sizes, width=None):
    """The step's dims for a mesh: the JAX entry point's (``width`` None)
    or ``width = dict(D=, H=, F=, E=, T=)`` with ``B = 2 * dp *
    n_micro`` as there."""
    n_micro = 2 * sizes["pp"]
    dims = dict(n_micro=n_micro, B=2 * sizes["dp"] * n_micro)
    if width is None:
        H = 2 * max(sizes["tp"], 1)
        dims.update(T=4 * sizes["sp"], H=H, Dh=4, D=H * 4, F=16,
                    E=2 * max(sizes["tp"], 1))
    else:
        dims.update(T=int(width["T"]), H=int(width["H"]),
                    Dh=int(width["D"]) // int(width["H"]),
                    D=int(width["D"]), F=int(width["F"]), E=int(width["E"]))
    return dims


def init_host(sizes, dims, seed=0):
    """The JAX entry point's weights and batch as numpy: ``N(0, 0.02)``
    weights then ``N(0, 1)`` x and y, drawn in its order."""
    rng = np.random.RandomState(seed)
    D, E, F, pp = dims["D"], dims["E"], dims["F"], sizes["pp"]
    shapes = {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D),
              "wg": (D, E), "w1": (E, D, F), "w2": (E, F, D),
              "pw1": (pp, D, F), "pw2": (pp, F, D), "wout": (D, D)}
    host = {n: rng.normal(0, 0.02, shapes[n]).astype(np.float32)
            for n in PARAMS}
    shape = (dims["B"], dims["T"], D)
    host["x"] = rng.normal(0, 1, shape).astype(np.float32)
    host["y"] = rng.normal(0, 1, shape).astype(np.float32)
    return host


def shard_host(host, mesh):
    """This rank's piece of every array of ``host`` by :data:`SPECS`."""
    from .parallel.mesh import NamedSharding, PartitionSpec
    return {n: np.ascontiguousarray(
        NamedSharding(mesh, PartitionSpec(*SPECS[n])).shard(v))
        for n, v in host.items()}


def _axis(mesh, name):
    return mesh.axis_size(name) if mesh is not None \
        and name in mesh.axis_names else 1


def _loss_parts(p, x, y, mesh, dims, plain):
    """This rank's share of the squared error and the global aux loss."""
    import torch
    from .parallel.collectives import copy_to_axis, reduce_from_axis
    from .parallel.flash_attention import flash_attention
    from .parallel.moe import moe_ffn
    from .parallel.pipeline import pipeline_apply
    from .parallel.ring_attention import ring_attention
    tp, sp = _axis(mesh, "tp"), _axis(mesh, "sp")
    B, T, D = x.shape
    H, Dh = dims["H"] // tp, dims["Dh"]
    h = x
    hin = copy_to_axis(h, mesh, "tp")
    q, k, v = ((hin @ p[n]).reshape(B, T, H, Dh) for n in ("wq", "wk", "wv"))
    if sp == 1 and plain:
        attn = flash_attention(q, k, v, causal=True, impl="plain")
    else:
        attn = ring_attention(q, k, v, mesh=mesh, axis="sp", causal=True)
    h = h + reduce_from_axis(attn.reshape(B, T, H * Dh) @ p["wo"], mesh,
                             "tp")
    moe_out, aux = moe_ffn(h, p["wg"], p["w1"], p["w2"], k=2, mesh=mesh,
                           ep_axis="tp")
    h = h + moe_out

    def stage(w, z):
        return z + torch.relu(z @ w[0]) @ w[1]
    n_micro = dims["n_micro"]
    mbs = h.reshape(n_micro, B // n_micro, T, D)
    if _axis(mesh, "pp") > 1:
        mbs = pipeline_apply(stage, (p["pw1"], p["pw2"]), mbs, mesh=mesh,
                             axis="pp")
    else:
        for s in range(p["pw1"].shape[0]):
            mbs = stage((p["pw1"][s], p["pw2"][s]), mbs)
    h = mbs.reshape(B, T, D)
    out = copy_to_axis(h, mesh, "tp") @ p["wout"]     # this rank's columns
    if tp > 1:
        y = y.narrow(-1, mesh.axis_index("tp") * (D // tp), D // tp)
    sq = ((out - y) ** 2).sum() / float(dims["B"] * dims["T"] * dims["D"])
    return sq, aux


def dryrun_step(params, x, y, mesh, dims, plain=False):
    """One SGD step (lr :data:`LR`) of the dryrun loss on this rank's
    shards (tensors):
    returns ``(loss, new_params, grads, sync_s)``: the global loss, this
    rank's updated shards, their exchanged gradients and the seconds of
    the exchange. ``mesh``
    None is the one-process twin on whole arrays (``plain``: the plain
    attention there instead of the flash kernels)."""
    import torch
    from .parallel.collectives import all_reduce
    names = list(PARAMS)
    leaves = [params[n].detach().requires_grad_(True) for n in names]
    p = dict(zip(names, leaves))
    sq, aux = _loss_parts(p, x, y, mesh, dims, plain)
    grads = torch.autograd.grad(sq + AUX_WEIGHT * aux, leaves)
    t0 = time.perf_counter()
    with torch.no_grad():
        live = [a for a in ("dp", "sp") if _axis(mesh, a) > 1]
        for a in live:
            grads = [all_reduce(g, mesh, a) for g in grads]
        sq = sq.detach()
        for a in ("dp", "sp", "tp"):
            if _axis(mesh, a) > 1:
                sq = all_reduce(sq, mesh, a)
        loss = float(sq + AUX_WEIGHT * aux.detach())
        new = {n: w - LR * g for n, w, g in zip(names, leaves, grads)}
    return loss, new, dict(zip(names, grads)), time.perf_counter() - t0


def _run_one(run, device, outdir, rank):
    """One dryrun on this rank (``launch_runs``' worker side): the mesh,
    this rank's shards, the step (twice from the same weights: the first
    checked, with the flash kernels' launch counts zeroed before it and
    read after, the second timed); the updated shards and gradients to
    ``<tag>.rank<r>.npz`` and the readings returned."""
    import torch
    from . import profiler
    from .parallel import create_mesh
    from .parallel import flash_attention as flash
    sizes = mesh_sizes(run["n"], run.get("degenerate"))
    dims = jax_dims(sizes, run.get("width"))
    mesh = create_mesh(sizes)
    local = shard_host(init_host(sizes, dims), mesh)
    t = {n: torch.from_numpy(v).to(device) for n, v in local.items()}
    params = {n: t[n] for n in PARAMS}
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    staged0 = profiler.counters().get("collective_staged_bytes", 0)
    flash.reset_launches()
    loss, new, grads, _ = dryrun_step(params, t["x"], t["y"], mesh, dims)
    launches = dict(flash.launches)
    staged = profiler.counters().get("collective_staged_bytes", 0) - staged0
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sync_s = dryrun_step(params, t["x"], t["y"], mesh, dims)[-1]
    if cuda:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    np.savez(os.path.join(outdir, "%s.rank%d.npz" % (run["tag"], rank)),
             **{n: v.detach().cpu().numpy() for n, v in new.items()},
             **{"grad_" + n: v.cpu().numpy() for n, v in grads.items()})
    moved = any(not torch.equal(new[n], params[n]) for n in PARAMS)
    return dict(tag=run["tag"], sizes=sizes, dims=dims, loss=loss, ms=ms,
                moved=moved, launches=launches,
                sync_ms=sync_s * 1e3, staged_bytes=int(staged),
                param_bytes=int(sum(v.nbytes for n, v in local.items()
                                    if n in PARAMS)),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda
                else None)


def _rank_main(outdir, device, runs_json):
    """A worker of :func:`launch_runs`: importing the package joined the
    launcher's process group."""
    import traceback
    import torch
    from .parallel import distributed
    rank = distributed.rank()
    res = {"rank": rank, "backend": distributed.backend(), "runs": []}
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            torch.set_num_threads(1)
        with open(runs_json) as f:
            runs = json.load(f)
        for run in runs:
            res["runs"].append(_run_one(run, device, outdir, rank))
            distributed.barrier()
    except Exception:                              # noqa: BLE001
        res["error"] = traceback.format_exc()
        print(res["error"], file=sys.stderr, flush=True)
    atomic_write_bytes(os.path.join(outdir, "rank%d.json" % rank),
                       json.dumps(res).encode())
    return 1 if "error" in res else 0


def launch_runs(n, runs, device, outdir, timeout=900):
    """Run the dryruns ``runs`` (``[{"tag", "n", "degenerate", "width"}]``,
    each over all ``n`` ranks in turn) under ``python -m mxnet_tpu_torch.
    tools.launch -n N``; returns each rank's readings (``rank<r>.json``
    in ``outdir``, the updated shards beside). A failing rank raises with
    the ranks' errors."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs_json = os.path.join(outdir, "runs.json")
    atomic_write_bytes(runs_json, json.dumps(runs).encode())
    env = {k: v for k, v in os.environ.items() if not k.startswith("DMLC_")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    if str(device).startswith("cpu"):
        env["MXNET_DEFAULT_CONTEXT"] = "cpu"
        env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(n), sys.executable, "-m", "mxnet_tpu_torch.dryrun", "rank",
           outdir, str(device), runs_json]
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)
    ranks = []
    for r in range(n):
        path = os.path.join(outdir, "rank%d.json" % r)
        ranks.append(json.load(open(path)) if os.path.exists(path)
                     else {"error": "rank %d wrote no result" % r})
    errors = [r.get("error") for r in ranks if "error" in r]
    if proc.returncode != 0 or errors:
        raise RuntimeError(
            "dryrun ranks failed (launcher exit %d):\n%s\n%s"
            % (proc.returncode, "\n".join(errors)[-4000:],
               proc.stderr[-2000:]))
    return ranks


def dryrun_multichip(n_devices=8, device=None, out_dir=None):
    """One training step of the toy transformer over ``n_devices`` ranks
    of this host (``tools.launch``), every axis of ``mesh_sizes`` live.
    On ``cuda:0`` by default (every rank on the one card, gloo between
    them); on the CPU with ``device="cpu"`` or ``MXNET_DEFAULT_CONTEXT=
    cpu``. Prints ``dryrun_multichip OK: n=... mesh=... loss=...`` and
    returns rank 0's readings; the ranks' updated shards stay in
    ``out_dir`` when one is given."""
    from .context import resolve_device
    device = resolve_device(device)
    degenerate = os.environ.get("MXNET_TPU_DRYRUN_DEGENERATE_AXIS", "pp")
    sizes = mesh_sizes(n_devices, degenerate)
    tmp = out_dir or tempfile.mkdtemp(prefix="dryrun_")
    try:
        ranks = launch_runs(n_devices, [dict(
            tag="dryrun", n=n_devices, degenerate=degenerate)], device, tmp)
    finally:
        if out_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    rec = ranks[0]["runs"][0]
    if not np.isfinite(rec["loss"]):
        raise RuntimeError("dryrun loss not finite: %r" % rec["loss"])
    if not any(r["runs"][0]["moved"] for r in ranks):
        raise RuntimeError("dryrun step did not update the parameters")
    print("dryrun_multichip OK: n=%d mesh=%s loss=%.5f"
          % (n_devices, sizes, rec["loss"]))
    return rec


if __name__ == "__main__":
    if sys.argv[1:2] == ["rank"]:
        sys.exit(_rank_main(*sys.argv[2:5]))
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
