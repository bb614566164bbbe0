"""Shared harness of the port's rank-mesh tests (``tests/test_torch_
parallel.py``, ``test_torch_data_parallel.py``, ``test_torch_param_
shard.py``): one world of gloo CPU ranks per test module, spawned over a
``file://`` store under ``tmp_path`` (no TCP port to race for under
xdist), each rank running a suite of checks of the port and saving what
it computed; the test module holds those results to the JAX package on
a mesh of the same sizes (``create_mesh({...}, devices=jax.devices()[:N])``
on the 8 CPU devices) and to the port's own claims.

Run as a script, this file is one rank: ``python torch_mesh_ranks.py
SUITE STORE RANK WORLD CONFIG.json OUT_DIR``. It imports torch and the
port only. Arrays land in ``OUT_DIR/rankR.npz``, everything else in
``OUT_DIR/rankR.json``; a check that raised leaves its traceback under
``error/<check>``, so one failure does not hide the others."""
import json
import os
import subprocess
import sys
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 150

# the shared problem sizes (the JAX tests' own)
ATTN_CASES = [("ring", False, (2, 32, 4, 8), 0), ("ring", True, (1, 16, 2, 4), 1),
              ("ulysses", False, (2, 16, 8, 4), 2),
              ("ulysses", True, (2, 16, 8, 4), 3)]
OPTIMIZERS = [("sgd", {"learning_rate": 0.05}),
              ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
              ("adam", {"learning_rate": 0.01}),
              ("adagrad", {"learning_rate": 0.05}),
              ("rmsprop", {"learning_rate": 0.01})]
RS_DIMS = (3, 5, 7, 13)
BUCKET_SHAPES = [(4, 3), (5,), (2, 2)]


def spawn(tmp_path, suite, world, config=None):
    """Run ``suite`` on ``world`` ranks; returns each rank's results
    (a dict merging its npz and json). Any rank failing fails the call,
    with every rank's last output."""
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(config or {}))
    out = tmp_path / "out"
    out.mkdir(exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "MXNET_"))}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""),
               MXNET_DEFAULT_CONTEXT="cpu", MXNET_DATA_PIPELINE="0",
               MXNET_KVSTORE_TIMEOUT="120", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite,
         str(tmp_path / "store"), str(r), str(world), str(cfg), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        cwd=str(tmp_path)) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join("rank %d:\n%s" % (r, logs[r][-3000:])
                              for r in range(world))
    results = []
    for r in range(world):
        res = dict(np.load(str(out / ("rank%d.npz" % r))))
        with open(str(out / ("rank%d.json" % r))) as f:
            res.update(json.load(f))
        results.append(res)
    return results


def errors(results, prefix):
    """The tracebacks of the checks under ``prefix`` on any rank."""
    return ["rank %d %s:\n%s" % (r, k, v) for r, res in enumerate(results)
            for k, v in res.items() if k.startswith("error/" + prefix)]


def attn_inputs(shape, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(4)]


def dist_net_init(shapes):
    """The JAX tests' initial weights: RandomState(11), sorted by name,
    scaled by 0.1."""
    rng = np.random.RandomState(11)
    return [rng.randn(*s).astype(np.float32) * 0.1 for s in shapes]


def dist_batches(steps, classes=10, rows=16, width=20):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(steps):
        out.append((rng.randn(rows, width).astype(np.float32),
                    rng.randint(0, classes, (rows,)).astype(np.float32)))
    return out


def bn_batches(steps=3):
    rng = np.random.RandomState(5)
    return [(rng.randn(8, 3, 6, 6).astype(np.float32) * 2 + 1,
             rng.randint(0, 4, (8,)).astype(np.float32))
            for _ in range(steps)]


def bn_init(shapes):
    rng = np.random.RandomState(13)
    return [rng.uniform(-0.3, 0.3, s).astype(np.float32) for s in shapes]


def dp_step_data(steps=50):
    """tests/test_parallel.py's regression problem."""
    rng = np.random.RandomState(0)
    w_true = rng.randn(4, 1).astype(np.float32)
    batches = []
    for _ in range(steps):
        x = rng.randn(32, 4).astype(np.float32)
        batches.append((x, x @ w_true))
    return batches


def fsdp_step_data():
    rng = np.random.RandomState(1)
    host = {"fc1_weight": rng.randn(32, 8).astype(np.float32) * 0.1,
            "fc1_bias": np.zeros((8,), np.float32)}
    batch = {"x": rng.randn(16, 32).astype(np.float32),
             "y": rng.randn(16, 8).astype(np.float32)}
    return host, batch


def pipe_data():
    """The pipeline problem: 2 stages of ``tanh(h @ w + b)``, 4
    microbatches of 4 rows of width 6 (a dp rank takes 2 rows of each)."""
    rng = np.random.RandomState(0)
    return (rng.normal(0, 0.5, (2, 6, 6)).astype(np.float32),
            rng.normal(0, 0.5, (2, 6)).astype(np.float32),
            rng.normal(0, 1, (4, 4, 6)).astype(np.float32))


def moe_data():
    """The MoE problem over {dp: 2, tp: 2}: B4 T4 D6 F8, 4 experts."""
    rng = np.random.RandomState(5)
    return (rng.normal(0, 1, (4, 4, 6)).astype(np.float32),
            rng.normal(0, 1, (6, 4)).astype(np.float32),
            rng.normal(0, 0.5, (4, 6, 8)).astype(np.float32),
            rng.normal(0, 0.5, (4, 8, 6)).astype(np.float32))


MOE_CAPACITY_FACTOR = 1.0        # some claims overflow and drop
SP_STEPS = 3
SP_LR = 0.1


def sp_nets(mx):
    """The sequence-parallel nets, from either package: ``probe``
    (attention over (B, T, 16) inputs, then a per-token Dense(10)) and
    ``positioned`` (token and position embeddings, the position ids from
    ``arange_like`` along the sequence, then the same)."""
    from_gluon = mx.gluon

    def probe():
        net = from_gluon.nn.HybridSequential(prefix="spprobe_")
        with net.name_scope():
            net.add(from_gluon.contrib.nn.MeshMultiHeadAttention(
                16, 2, causal=True), from_gluon.nn.Dense(10, flatten=False))
        return net

    class Positioned(from_gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="sppos_")
            with self.name_scope():
                self.tok = from_gluon.nn.Embedding(12, 16)
                self.pos = from_gluon.nn.Embedding(8, 16)
                self.attn = from_gluon.contrib.nn.MeshMultiHeadAttention(
                    16, 2, causal=True)
                self.out = from_gluon.nn.Dense(10, flatten=False)

        def hybrid_forward(self, F, x):
            h = self.tok(x) + self.pos(F.contrib.arange_like(x, axis=1))
            return self.out(self.attn(h))
    return {"probe": probe, "positioned": Positioned}


def sp_batches(kind):
    """SP_STEPS global batches of 4 rows of 8 positions, per-token
    labels."""
    rng = np.random.RandomState(7)
    out = []
    for _ in range(SP_STEPS):
        x = rng.normal(0, 1, (4, 8, 16)).astype(np.float32) \
            if kind == "probe" \
            else rng.randint(0, 12, (4, 8)).astype(np.float32)
        out.append((x, rng.randint(0, 10, (4, 8)).astype(np.float32)))
    return out


def sp_net(mx, kind):
    """A net of ``sp_nets`` with the shared initial weights."""
    net = sp_nets(mx)[kind]()
    net.initialize()
    net(mx.nd.array(sp_batches(kind)[0][0][:1]))
    plist = sorted(net.collect_params().items())
    for (_, p), v in zip(plist, dist_net_init([p.data().shape
                                               for _, p in plist])):
        p.set_data(mx.nd.array(v))
    return net


def sp_step_data(steps=3):
    """make_data_parallel_step's per-token problem: (4, 8, 4) inputs,
    (4, 8, 1) targets."""
    rng = np.random.RandomState(9)
    w_true = rng.randn(4, 1).astype(np.float32)
    out = []
    for _ in range(steps):
        x = rng.randn(4, 8, 4).astype(np.float32)
        out.append((x, x @ w_true))
    return out


TP_WIDTH = 32                    # the tp probe's inputs


def tp_net(mx, prefix="tpnet_"):
    """The tp probe: Dense(64, relu) -> Dense(10) over 32 inputs."""
    from_gluon = mx.gluon
    net = from_gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(from_gluon.nn.Dense(64, activation="relu"),
                from_gluon.nn.Dense(10))
    net.initialize()
    net(mx.nd.array(np.zeros((16, TP_WIDTH), np.float32)))
    plist = sorted(net.collect_params().items())
    for (_, p), v in zip(plist, dist_net_init([p.data().shape
                                               for _, p in plist])):
        p.set_data(mx.nd.array(v))
    return net


def jax_dist_run(n_dev, overlap=True, opt="adam", steps=5, classes=10,
                  load=None, skip=0, prefix="gsync_", param_shard=None,
                  opt_params=None, bucket_mb=0.001):
    """The JAX package's DistributedTrainer on ``n_dev`` CPU devices over
    the net, initial weights and batches the ranks' ``dist_run`` uses
    (called from the test process only: it imports JAX)."""
    import jax
    import mxnet_tpu as jmx
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu import parallel as jpar
    from mxnet_tpu.gluon import nn
    mesh = jpar.create_mesh({"dp": n_dev}, devices=jax.devices()[:n_dev])
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(32, activation="relu"), nn.Dense(classes))
    net.initialize()
    net(jmx.nd.array(np.zeros((16, 20), np.float32)))
    plist = sorted(net.collect_params().items())
    for (_, p), v in zip(plist, dist_net_init([p.data().shape
                                                 for _, p in plist])):
        p.set_data(jmx.nd.array(v))
    tr = jpar.DistributedTrainer(
        net, jgluon.loss.SoftmaxCrossEntropyLoss(), mesh, optimizer=opt,
        optimizer_params=opt_params or {"learning_rate": 0.01},
        grad_overlap=overlap, bucket_mb=bucket_mb, param_shard=param_shard)
    if load is not None:
        tr.load_checkpoint(*load)
    batches = dist_batches(skip + steps, classes)
    losses = []
    for x, y in batches[skip:]:
        losses.append(float(tr.fit_batch(jmx.nd.array(x),
                                         jmx.nd.array(y)).asnumpy()))
    tr.sync_gluon_params()
    return (np.array(losses), [p.data().asnumpy() for _, p in
                               sorted(net.collect_params().items())], tr)


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------

class Rank:
    def __init__(self, rank, world, cfg):
        self.rank, self.world, self.cfg = rank, world, cfg
        self.res = {}

    def put(self, key, value):
        self.res[key] = value

    def check(self, name, fn):
        try:
            fn()
        except Exception:
            self.res["error/" + name] = traceback.format_exc()

    def save(self, out):
        arrays = {k: np.asarray(v) for k, v in self.res.items()
                  if isinstance(v, np.ndarray)}
        other = {k: v for k, v in self.res.items() if k not in arrays}
        np.savez(os.path.join(out, "rank%d.npz" % self.rank), **arrays)
        with open(os.path.join(out, "rank%d.json" % self.rank), "w") as f:
            json.dump(other, f)


def _np(t):
    return t.detach().cpu().numpy().copy()


def check_mesh(R, mx, par):
    mesh = par.create_mesh({"dp": R.world})
    R.put("mesh/axes", par.mesh_axes(mesh))
    R.put("mesh/local", par.mesh_axes(par.local_mesh("dp")))
    R.put("mesh/auto", int(np.prod(list(par.mesh_axes(
        par.auto_mesh(R.world)).values()))))
    R.put("mesh/make", [list(par.make_mesh().axis_names),
                        list(par.make_mesh().devices.shape)])
    try:
        par.create_mesh({"dp": R.world + 1})
        R.put("mesh/oversize", "")
    except ValueError as exc:
        R.put("mesh/oversize", str(exc))
    R.put("mesh/link", list(par.mesh.link_split(mesh, "dp", 1000)))
    with par.use_mesh(mesh):
        R.put("mesh/current", par.current_mesh() is mesh)
    R.put("mesh/after", par.current_mesh() is None)


def check_collectives(R, mx, par):
    import torch
    mesh = par.local_mesh("dp")
    n, r = R.world, R.rank
    x = torch.arange(16, dtype=torch.float32)
    per = 16 // n
    xs = x[r * per:(r + 1) * per]
    R.put("coll/all_reduce", _np(par.all_reduce(xs, mesh, "dp")))
    R.put("coll/all_reduce_max", _np(par.all_reduce(xs, mesh, "dp",
                                                    op="max")))
    R.put("coll/all_reduce_mean", _np(par.all_reduce(xs, mesh, "dp",
                                                     op="mean")))
    R.put("coll/all_gather", _np(par.all_gather(xs, mesh, "dp")))
    R.put("coll/all_gather_stacked", _np(par.all_gather(xs, mesh, "dp",
                                                        tiled=False)))
    for d0 in RS_DIMS:
        val = np.random.RandomState(d0).randint(-100, 100, (d0, 3)) \
            .astype(np.float32)
        R.put("coll/rs%d" % d0, _np(par.reduce_scatter(
            torch.from_numpy(val), mesh)))
    val = np.arange(16, dtype=np.float32).reshape(16, 1)
    R.put("coll/rs_div", _np(par.reduce_scatter(torch.from_numpy(val),
                                                mesh)))
    rng = np.random.RandomState(3)
    stacked = [rng.normal(0, 1, (n,) + s).astype(np.float32)
               for s in BUCKET_SHAPES]
    flat = par.bucket_reduce_scatter(
        [torch.from_numpy(v[r]) for v in stacked], mesh)
    R.put("coll/bucket_local", _np(flat))
    R.put("coll/bucket_full", _np(par.bucket_all_gather(flat, mesh)))
    R.put("coll/ppermute", _np(par.ppermute(
        xs, mesh, "dp", [(i, (i + 1) % n) for i in range(n)])))
    R.put("coll/ppermute_partial", _np(par.ppermute(xs, mesh, "dp",
                                                    [(0, 1)])))
    R.put("coll/broadcast", _np(par.broadcast(xs, mesh, "dp", root=n - 1)))
    block = torch.arange(2 * 4 * n, dtype=torch.float32).reshape(2, 4 * n) \
        + 100 * r
    R.put("coll/all_to_all", _np(par.all_to_all(block, mesh, "dp", 1, 0)))
    R.put("coll/psum_eager", _np(par.psum_eager([xs, xs, xs])))
    par.barrier()


def _attn(R, par, impl, causal, shape, seed, mesh, dp_axis=None):
    """This rank's output slice and its q/k/v gradient slices for one
    attention case: T split over ``sp`` (and B over ``dp_axis``)."""
    import torch
    q, k, v, dout = attn_inputs(shape, seed)
    sp = mesh.axis_size("sp")
    si = mesh.axis_index("sp")
    T = shape[1] // sp
    sl = [slice(None), slice(si * T, (si + 1) * T)]
    if dp_axis is not None:
        B = shape[0] // mesh.axis_size(dp_axis)
        di = mesh.axis_index(dp_axis)
        sl[0] = slice(di * B, (di + 1) * B)
    sl = tuple(sl)
    ts = [torch.from_numpy(a[sl].copy()).requires_grad_(True)
          for a in (q, k, v)]
    fn = par.ring_attention if impl == "ring" else par.ulysses_attention
    out = fn(*ts, mesh=mesh, axis="sp", causal=causal)
    out.backward(torch.from_numpy(dout[sl].copy()))
    return [_np(out)] + [_np(t.grad) for t in ts]


def check_attention(R, mx, par):
    mesh = par.create_mesh({"sp": R.world})
    for impl, causal, shape, seed in ATTN_CASES:
        key = "attn/%s_%s" % (impl, "causal" if causal else "full")
        for name, val in zip(("out", "dq", "dk", "dv"),
                             _attn(R, par, impl, causal, shape, seed, mesh)):
            R.put("%s/%s" % (key, name), val)


def check_attention_op(R, mx, par):
    """``_contrib_flash_attention(impl=ring|ulysses|auto)`` under an sp
    mesh: this rank's slice in, its slice of the output back."""
    mesh = par.create_mesh({"sp": R.world})
    q, k, v, _ = attn_inputs((2, 16, 8, 4), 7)
    T = 16 // R.world
    sl = (slice(None), slice(R.rank * T, (R.rank + 1) * T))
    args = [mx.nd.array(a[sl]) for a in (q, k, v)]
    with par.use_mesh(mesh):
        for impl in ("ring", "ulysses", "auto"):
            out = mx.nd.contrib.flash_attention(*args, impl=impl,
                                                causal=True)
            R.put("attn_op/%s" % impl, out.asnumpy())


def check_attention4(R, mx, par):
    """ring/Ulysses over the sp axis of a {dp: 2, sp: 2} mesh, each dp
    row holding its own rows of the batch; then the axis groups."""
    import torch
    mesh = par.create_mesh({"dp": 2, "sp": 2})
    for impl, causal, shape, seed in ATTN_CASES:
        if shape[0] % 2:
            continue
        key = "attn4/%s_%s" % (impl, "causal" if causal else "full")
        for name, val in zip(("out", "dq", "dk", "dv"),
                             _attn(R, par, impl, causal, shape, seed, mesh,
                                   dp_axis="dp")):
            R.put("%s/%s" % (key, name), val)
    me = torch.tensor([float(R.rank)])
    R.put("groups/dp", _np(par.all_reduce(me, mesh, "dp")))
    R.put("groups/sp", _np(par.all_reduce(me, mesh, "sp")))
    R.put("groups/coords", [mesh.axis_index("dp"), mesh.axis_index("sp")])
    # both dp paths train over the same mesh, each rank on its slice
    from mxnet_tpu_torch import gluon
    tr = par.DistributedTrainer(sp_net(mx, "probe"),
                                gluon.loss.SoftmaxCrossEntropyLoss(), mesh,
                                optimizer="sgd",
                                optimizer_params={"learning_rate": SP_LR})
    R.put("sp_train/trainer", [float(tr.fit_batch(
        mx.nd.array(x), mx.nd.array(y)).asnumpy())
        for x, y in sp_batches("probe")])
    step, _ = par.make_data_parallel_step(
        lambda p, b: ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), mesh,
        optimizer_update=lambda p, g: p - 0.1 * g)
    params, losses = {"w": torch.zeros(4, 1)}, []
    for x, y in sp_step_data():
        loss, params = step(params, {"x": x, "y": y})
        losses.append(float(loss))
    R.put("sp_train/step", losses)


def check_dp_step(R, mx, par):
    import torch
    mesh = par.local_mesh("dp")

    def loss_fn(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        return ((pred - batch["y"]) ** 2).mean()

    for overlap in (False, True):
        step, _ = par.make_data_parallel_step(
            loss_fn, mesh, optimizer_update=lambda p, g: p - 0.2 * g,
            grad_overlap=overlap, bucket_mb=1e-6)
        params = {"w": torch.zeros(4, 1), "b": torch.zeros(1)}
        losses = []
        for i, (x, y) in enumerate(dp_step_data()):
            loss, params = step(params, {"x": x, "y": y})
            losses.append(float(loss))
            if i == 0:
                R.put("dp_step/%d/first_w" % overlap, _np(params["w"]))
        R.put("dp_step/%d/losses" % overlap, np.array(losses))
        R.put("dp_step/%d/w" % overlap, _np(params["w"]))
        R.put("dp_step/%d/b" % overlap, _np(params["b"]))


def dist_net(mx, classes=10, prefix="gsync_", units=32):
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(nn.Dense(units, activation="relu"), nn.Dense(classes))
    net.initialize()
    net(mx.nd.array(np.zeros((16, 20), np.float32)))
    plist = sorted(net.collect_params().items())
    for (_, p), v in zip(plist, dist_net_init(
            [p.data().shape for _, p in plist])):
        p.set_data(mx.nd.array(v))
    return net


def dist_run(mx, par, overlap, opt="adam", opt_params=None, steps=5,
             bucket_mb=0.001, param_shard=None, mesh=None, classes=10,
             load=None, prefix="gsync_", after_load_skip=0):
    from mxnet_tpu_torch import gluon
    mesh = mesh or par.local_mesh("dp")
    net = dist_net(mx, classes=classes, prefix=prefix)
    tr = par.DistributedTrainer(
        net, gluon.loss.SoftmaxCrossEntropyLoss(), mesh, optimizer=opt,
        optimizer_params=opt_params or {"learning_rate": 0.01},
        grad_overlap=overlap, bucket_mb=bucket_mb, param_shard=param_shard)
    if load is not None:
        tr.load_checkpoint(*load)
    batches = dist_batches(after_load_skip + steps, classes)
    losses = [float(tr.fit_batch(mx.nd.array(x), mx.nd.array(y)).asnumpy())
              for x, y in batches[after_load_skip:]]
    tr.sync_gluon_params()
    params = [p.data().asnumpy()
              for _, p in sorted(net.collect_params().items())]
    return losses, params, tr


def check_bitexact(R, mx, par):
    for k, (opt, op) in enumerate(OPTIMIZERS):
        for overlap in (False, True):
            losses, params, tr = dist_run(mx, par, overlap, opt, op)
            key = "bitexact/%d/%d" % (k, overlap)
            R.put(key + "/losses", np.array(losses))
            for i, p in enumerate(params):
                R.put(key + "/p%d" % i, p)
            R.put(key + "/buckets", len(tr._plan.buckets))
            R.put(key + "/overlap", bool(tr.overlap))


def check_zero1(R, mx, par):
    for overlap in (False, True):
        losses, params, tr = dist_run(mx, par, overlap, "adam", steps=1)
        R.put("zero1/%d/loss" % overlap, np.array(losses))
        for i, p in enumerate(params):
            R.put("zero1/%d/p%d" % (overlap, i), p)
        R.put("zero1/%d/bytes" % overlap, tr.state_bytes_per_device())
        R.put("zero1/%d/local_sizes" % overlap,
              [int(a.numel()) for a in tr._state_vals])
        R.put("zero1/%d/padded_sizes" % overlap,
              [b.padded_size for b in tr._plan.buckets
               for _ in range(tr._sync_state.n_slots)])


def check_placed_once(R, mx, par):
    _, _, tr = dist_run(mx, par, True, "sgd", {"learning_rate": 0.05},
                        steps=2)
    R.put("placed/dispatch", tr.dispatch_count)
    R.put("placed/dirty", tr._gluon_dirty)
    R.put("placed/tensors", all(hasattr(v, "device")
                                for v in tr._param_vals))


def check_unknown_optimizer(R, mx, par):
    from mxnet_tpu_torch import gluon
    try:
        par.DistributedTrainer(gluon.nn.Dense(4),
                               gluon.loss.SoftmaxCrossEntropyLoss(),
                               par.local_mesh("dp"), optimizer="no_such")
        R.put("unknown_opt", "")
    except Exception as exc:
        R.put("unknown_opt", type(exc).__name__)


def check_checkpoint(R, mx, par):
    prefix = os.path.join(R.cfg["tmp"], "ck")
    ref, _, _ = dist_run(mx, par, True, "adam", steps=6)
    _, _, tr1 = dist_run(mx, par, True, "adam", steps=3)
    tr1.save_checkpoint(prefix, 0)
    losses, _, _ = dist_run(mx, par, True, "adam", steps=3,
                            load=(prefix, 0), after_load_skip=3)
    R.put("ckpt/ref", np.array(ref))
    R.put("ckpt/resumed", np.array(losses))
    R.put("ckpt/prefix", prefix)
    # a different bucket partition refuses, leaving the trainer as it was
    _, _, tr2 = dist_run(mx, par, True, "adam", steps=1, bucket_mb=4.0)
    before = [_np(v) for v in tr2._param_vals]
    try:
        tr2.load_checkpoint(prefix, 0)
        R.put("ckpt/reject", "")
    except Exception as exc:
        R.put("ckpt/reject", str(exc))
    R.put("ckpt/untouched", all(
        (a == _np(v)).all() for a, v in zip(before, tr2._param_vals)))
    R.put("ckpt/buckets", [len(tr1._plan.buckets), len(tr2._plan.buckets)])


def check_cross_load(R, mx, par):
    """A checkpoint the JAX package's 8-device trainer wrote, loaded on
    these ranks (then one more step); and this rank's own save after two
    steps, for the JAX package to load."""
    prefix = R.cfg.get("jax_ckpt")
    if prefix:
        losses, params, tr = dist_run(
            mx, par, True, "adam", steps=1, load=(prefix, 0),
            param_shard=R.cfg.get("jax_ckpt_fsdp", False),
            after_load_skip=2, prefix=R.cfg.get("prefix", "gsync_"))
        R.put("cross/loss", np.array(losses))
        for i, p in enumerate(params):
            R.put("cross/p%d" % i, p)
        R.put("cross/local_sizes", [int(v.numel()) for v in tr._param_vals])
    out = os.path.join(R.cfg["tmp"], "port_ck")
    _, params, tr = dist_run(mx, par, True, "adam", steps=2,
                             param_shard=R.cfg.get("jax_ckpt_fsdp", False),
                             prefix=R.cfg.get("prefix", "gsync_"))
    tr.save_checkpoint(out, 0)
    R.put("cross/port_prefix", out)
    for i, p in enumerate(params):
        R.put("cross/port_p%d" % i, p)
    losses, params, _ = dist_run(
        mx, par, True, "adam", steps=1, load=(out, 0), after_load_skip=2,
        param_shard=R.cfg.get("jax_ckpt_fsdp", False),
        prefix=R.cfg.get("prefix", "gsync_"))
    R.put("cross/port_next_loss", np.array(losses))
    for i, p in enumerate(params):
        R.put("cross/port_next_p%d" % i, p)


def check_seed_export(R, mx, par):
    import torch
    from mxnet_tpu_torch.parallel import grad_sync
    mesh = par.local_mesh("dp")
    shapes = [(5, 3), (7,), (2, 2)]
    plan = grad_sync.GradSyncPlan(shapes, ["float32"] * 3,
                                  axis_size=R.world, cap_bytes=4 * 10)
    st = grad_sync.ShardedOptState(plan, mesh)
    st.n_slots, st._slot_dtypes = 2, [torch.float32, torch.float32]
    st.device = torch.device("cpu")
    rng = np.random.RandomState(2)
    per_param = {i: [rng.normal(0, 1, s).astype(np.float32)
                     for _ in range(2)] for i, s in enumerate(shapes)}
    st.seed_per_param(per_param)
    out = st.export_per_param(dict(enumerate(shapes)))
    R.put("seed/inverse", all((per_param[i][k] == out[i][k]).all()
                              for i in range(3) for k in range(2)))
    roster = st.checkpoint_roster()
    R.put("seed/keys", sorted(roster))
    R.put("seed/buckets", len(plan.buckets))
    host = {k: (v.full() if hasattr(v, "full") else v)
            for k, v in roster.items()}
    host = {k: v.numpy() if hasattr(v, "numpy") else v
            for k, v in host.items()}
    st2 = grad_sync.ShardedOptState(plan, mesh)
    st2.n_slots, st2._slot_dtypes = 2, [torch.float32, torch.float32]
    st2.device = torch.device("cpu")
    st2.load_host_flats(host)
    out2 = st2.export_per_param(dict(enumerate(shapes)))
    R.put("seed/reload", all((out[i][0] == out2[i][0]).all()
                             for i in range(3)))
    R.put("seed/local", [int(a.numel()) for a in st.ensure()])


def check_telemetry(R, mx, par):
    """The in-program accounting, the diagnose sync table's sink and the
    memory breakdown (rank 0 arms telemetry; both ranks train)."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel import grad_sync
    if R.rank == 0:
        telemetry.start()
        plan = grad_sync.GradSyncPlan([(100,)], ["float32"],
                                      axis_size=R.world)
        grad_sync.account_in_program_sync(plan)
        rep = telemetry.report()
        R.put("tel/bucket_row", rep["comms"]["grad_sync:bucket00"])
        R.put("tel/bucket_bytes", 2 * plan.buckets[0].nbytes)
        R.put("tel/steps", rep["events"]["grad_sync_steps"])
        telemetry.stop()
        sink = os.path.join(R.cfg["tmp"], "sync.jsonl")
        telemetry.start(filename=sink)
        telemetry.step_begin()
        plan = grad_sync.GradSyncPlan([(64,), (32,)], ["float32"] * 2,
                                      axis_size=R.world, cap_bytes=4 * 40)
        grad_sync.account_in_program_sync(plan)
        with telemetry.span("sync"):
            pass
        telemetry.step_end(samples=16)
        telemetry.stop()
        R.put("tel/sync_sink", sink)
        mem_sink = os.path.join(R.cfg["tmp"], "mem.jsonl")
        telemetry.start(filename=mem_sink)
    _, _, tr = dist_run(mx, par, True, "adam", steps=2, param_shard=True,
                        classes=R.cfg.get("classes", 10))
    if R.rank == 0:
        summary = telemetry.stop()
        R.put("tel/mem_sink", mem_sink)
        R.put("tel/breakdown", summary.get("memory_breakdown"))
        R.put("tel/state_bytes", tr.state_bytes_per_device())
        R.put("tel/events", summary.get("events") or {})
        R.put("tel/comms", sorted(summary.get("comms") or {}))


def check_batchnorm(R, mx, par):
    """A conv net with BatchNorm and SyncBatchNorm trained by the
    DistributedTrainer over dp: the moving statistics of the global
    batch."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    net = nn.HybridSequential(prefix="bnnet_")
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.Conv2D(4, 3, padding=1),
                gluon.contrib.nn.SyncBatchNorm(), nn.Activation("relu"),
                nn.GlobalAvgPool2D(), nn.Dense(4))
    net.initialize()
    batches = bn_batches()
    net(mx.nd.array(batches[0][0][:2]))
    plist = sorted(net.collect_params().items())
    for (name, p), v in zip(plist, bn_init([p.data().shape
                                            for _, p in plist])):
        if "running_var" in name:
            v = np.abs(v) + 1.0
        p.set_data(mx.nd.array(v))
    tr = par.DistributedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                par.local_mesh("dp"), optimizer="sgd",
                                optimizer_params={"learning_rate": 0.1},
                                grad_overlap=True)
    losses = [float(tr.fit_batch(mx.nd.array(x), mx.nd.array(y)).asnumpy())
              for x, y in batches]
    tr.sync_gluon_params()
    R.put("bn/losses", np.array(losses))
    for name, p in sorted(net.collect_params().items()):
        R.put("bn/" + name, p.data().asnumpy())


def check_fsdp(R, mx, par):
    for k, (opt, op) in enumerate(OPTIMIZERS[:3]):
        for shard in (False, True):
            losses, params, tr = dist_run(mx, par, True, opt, op,
                                          param_shard=shard, classes=9)
            key = "fsdp/%d/%d" % (k, shard)
            R.put(key + "/losses", np.array(losses))
            for i, p in enumerate(params):
                R.put(key + "/p%d" % i, p)
            R.put(key + "/flag", bool(tr.param_shard))
            if shard:
                R.put(key + "/plans", [[pl.sharded, pl.padded,
                                        list(pl.padded_shape)]
                                       for pl in tr._param_plans])
                R.put(key + "/local", [int(v.numel())
                                       for v in tr._param_vals])
                R.put(key + "/buckets", [bk.padded_size
                                         for bk in tr._plan.buckets])
    for shard in (False, True):
        losses, params, tr = dist_run(mx, par, False, "sgd",
                                      {"learning_rate": 0.05},
                                      param_shard=shard, classes=9)
        R.put("fsdp_no_overlap/%d/losses" % shard, np.array(losses))
        for i, p in enumerate(params):
            R.put("fsdp_no_overlap/%d/p%d" % (shard, i), p)
        R.put("fsdp_no_overlap/%d/flags" % shard,
              [bool(tr.param_shard), bool(tr.overlap)])
    for shard in (False, True):
        _, _, tr = dist_run(mx, par, True, steps=1, param_shard=shard,
                            classes=9)
        R.put("fsdp_bytes/%d" % shard, tr.param_bytes_per_device())
        R.put("fsdp_breakdown/%d" % shard, tr._memory_breakdown())
        R.put("fsdp_state/%d" % shard, tr.state_bytes_per_device())


def check_fsdp_checkpoint(R, mx, par):
    prefix = os.path.join(R.cfg["tmp"], "fsdp")
    ref, _, _ = dist_run(mx, par, True, steps=6, param_shard=True,
                         prefix="pshard_")
    _, _, tr1 = dist_run(mx, par, True, steps=3, param_shard=True,
                         prefix="pshard_")
    tr1.save_checkpoint(prefix, 0)
    R.put("fsdp_ckpt/prefix", prefix)
    losses, _, _ = dist_run(mx, par, True, steps=3, param_shard=True,
                            load=(prefix, 0), after_load_skip=3,
                            prefix="pshard_")
    R.put("fsdp_ckpt/ref", np.array(ref))
    R.put("fsdp_ckpt/resumed", np.array(losses))


def check_fsdp_dp_step(R, mx, par):
    import torch
    mesh = par.local_mesh("dp")
    host, batch = fsdp_step_data()

    def loss_fn(params, b):
        out = b["x"] @ params["fc1_weight"] + params["fc1_bias"]
        return ((out - b["y"]) ** 2).mean()

    for shard in (False, True):
        rules = par.ShardingRules(mesh)
        params = par.shard_params({k: torch.from_numpy(v)
                                   for k, v in host.items()}, mesh,
                                  rules=rules if shard else None)
        step, bsh = par.make_data_parallel_step(
            loss_fn, mesh, param_shard=shard, param_rules=rules)
        b = {k: bsh.place(torch.from_numpy(v)) for k, v in batch.items()}
        for _ in range(3):
            loss, params = step(params, b)
        R.put("fsdp_step/%d/loss" % shard, float(loss))
        for k, v in params.items():
            R.put("fsdp_step/%d/%s" % (shard, k), _np(v.full()))
            R.put("fsdp_step/%d/%s/local" % (shard, k),
                  list(v.local.shape))


def check_shard_params(R, mx, par):
    """``shard_params`` with the rules layer (a fallback and a pad, each
    noted by name) and with a legacy substring table."""
    import torch
    from mxnet_tpu_torch import telemetry
    mesh = par.local_mesh("dp")
    vals = {"fc1_weight": torch.ones(32, 4), "fc2_weight": torch.ones(9, 4),
            "fc1_bias": torch.ones(32)}
    telemetry.start()
    try:
        placed = par.shard_params(vals, mesh, rules=par.ShardingRules(mesh))
        padded = par.shard_params(vals, mesh, rules=par.ShardingRules(mesh),
                                  pad=True)
        events = telemetry.report().get("events") or {}
    finally:
        telemetry.stop()
    R.put("shard/fc1", [placed["fc1_weight"].is_fully_replicated,
                        list(placed["fc1_weight"].local.shape)])
    R.put("shard/fc2", [placed["fc2_weight"].is_fully_replicated,
                        list(placed["fc2_weight"].shape)])
    R.put("shard/bias", placed["fc1_bias"].is_fully_replicated)
    R.put("shard/padded", [list(padded["fc2_weight"].shape),
                           padded["fc2_weight"].is_fully_replicated])
    R.put("shard/events", {k: v for k, v in events.items()
                           if k.startswith("param_shard")})
    legacy = par.shard_params({"w_big": torch.ones(16, 2),
                               "other": torch.ones(16, 2)}, mesh,
                              rules={"w_": par.PartitionSpec("dp")})
    R.put("shard/legacy", [legacy["w_big"].is_fully_replicated,
                           legacy["other"].is_fully_replicated])


def check_make_mesh(R, mx, par):
    import torch
    P = par.PartitionSpec
    mesh = par.make_mesh(fsdp=R.world)
    R.put("make_mesh/axes", list(mesh.axis_names))
    R.put("make_mesh/shape", list(mesh.devices.shape))
    lay = par.SpecLayout.for_mesh(mesh)
    R.put("make_mesh/layout", [lay.data_axis, lay.fsdp_axis, lay.tp_axis])
    rules = par.ShardingRules(mesh)
    plan = rules.plan("stage1_fc1_weight", (8, 6))
    R.put("make_mesh/spec", list(plan.spec))
    R.put("make_mesh/bytes", plan.bytes_per_device("float32", mesh))
    R.put("make_mesh/padded", list(rules.plan("embed_weight",
                                              (9, 6)).padded_shape))
    host = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    placed = plan.sharding(mesh).place(host)
    R.put("make_mesh/local", _np(placed.local))
    R.put("make_mesh/full", _np(placed.full()))
    tp = par.make_mesh(tp=R.world)
    tplan = par.ShardingRules(tp).plan("stage1_fc1_weight", (8, 6))
    R.put("make_mesh/tp_spec", [None if a is None else a
                                for a in tplan.spec])
    R.put("make_mesh/tp_local", _np(tplan.sharding(tp).shard(host)))
    bsh = par.shard_batch(mesh, batch_axes=("data",))
    R.put("make_mesh/batch", list(bsh.shard(torch.zeros(4, 5)).shape))
    try:
        par.make_mesh(fsdp=3)
        R.put("make_mesh/bad", "")
    except ValueError as exc:
        R.put("make_mesh/bad", str(exc))
    R.put("make_mesh/spec_type", type(P("fsdp")).__name__)


def check_pipeline(R, mx, par):
    """``io.make_sharded_pipeline``: each rank's rows of the batch-
    divisible arrays, the rest whole, marked as placed."""
    mesh = par.local_mesh("dp")
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    y = np.arange(8, dtype=np.float32)
    it = mx.io.NDArrayIter(x, y, batch_size=4)
    pipe = mx.io.make_sharded_pipeline(it, mesh, prefetch_depth=2,
                                       num_workers=1)
    got = []
    for batch in pipe:
        got.append((batch.data[0].asnumpy(), batch.label[0].asnumpy(),
                    bool(getattr(batch.data[0], "_dp_local", False))))
    pipe.close() if hasattr(pipe, "close") else None
    R.put("pipe/data", np.stack([g[0] for g in got]))
    R.put("pipe/label", np.stack([g[1] for g in got]))
    R.put("pipe/marked", [g[2] for g in got])
    place = mx.io.pipeline._dp_placement(mesh, "cpu")
    R.put("pipe/whole", str(place("w", np.zeros((3, 2)))))


def check_pipeline_apply(R, mx, par):
    """``pipeline_apply`` over {pp: 2, dp: 2}: this rank's rows of every
    microbatch through both stages; the gradients of ``sum(out ** 2)``
    (this rank's rows) for its stage's w and b (summed over dp) and for
    its rows of the input."""
    import torch
    mesh = par.create_mesh({"pp": 2, "dp": 2})
    w, b, x = pipe_data()
    d = mesh.axis_index("dp")
    xs = torch.from_numpy(x[:, 2 * d:2 * d + 2].copy()).requires_grad_(True)
    stage = mesh.axis_index("pp")
    wt = torch.from_numpy(w[stage:stage + 1].copy()).requires_grad_(True)
    bt = torch.from_numpy(b[stage:stage + 1].copy()).requires_grad_(True)

    def fn(p, h):
        return torch.tanh(h @ p[0] + p[1])
    out = par.pipeline_apply(fn, (wt, bt), xs, mesh=mesh, axis="pp")
    R.put("pipe_apply/out", _np(out))
    (out ** 2).sum().backward()
    R.put("pipe_apply/dw", _np(par.all_reduce(wt.grad, mesh, "dp")))
    R.put("pipe_apply/db", _np(par.all_reduce(bt.grad, mesh, "dp")))
    R.put("pipe_apply/dx", _np(xs.grad))
    R.put("pipe_apply/coords", [stage, d])
    whole = par.pipeline_apply(fn, par.stack_stage_params(
        [(torch.from_numpy(w[i]), torch.from_numpy(b[i])) for i in (0, 1)]),
        xs.detach(), mesh=mesh, axis="pp")
    R.put("pipe_apply/stacked", _np(whole))


def check_pipeline_n_micro(R, mx, par):
    import torch
    mesh = par.create_mesh({"pp": 4})
    try:
        par.pipeline_apply(lambda w, h: h @ w, torch.zeros(4, 4, 4),
                           torch.zeros(2, 2, 4), mesh=mesh, axis="pp")
        R.put("pipe_micro", ["", ""])
    except Exception as exc:
        R.put("pipe_micro", [type(exc).__name__, str(exc)])


def check_autograd_collectives(R, mx, par):
    """The autograd collectives over {dp: 2, tp: 2} on integer-valued
    data (every sum exact): each one's value and the gradient of ``sum(
    out * c)`` with a rank-dependent cotangent ``c``."""
    import torch
    mesh = par.create_mesh({"dp": 2, "tp": 2})

    def run(name, fn):
        x = (torch.arange(4, dtype=torch.float32)
             + 10 * R.rank).requires_grad_(True)
        out = fn(x)
        c = torch.arange(out.numel(), dtype=torch.float32).reshape(
            out.shape) + 100 * R.rank
        (out * c).sum().backward()
        R.put("coll_grad/%s/out" % name, _np(out))
        R.put("coll_grad/%s/grad" % name, _np(x.grad))

    run("copy", lambda x: par.copy_to_axis(x, mesh, "tp"))
    run("reduce", lambda x: par.reduce_from_axis(x, mesh, "tp"))
    run("psum", lambda x: par.psum(x, mesh, "tp"))
    run("gather_slice", lambda x: par.gather_from_axis(x, mesh, "tp"))
    run("gather_sum", lambda x: par.gather_from_axis(x, mesh, "tp",
                                                     grad="sum"))
    run("gather_both", lambda x: par.gather_from_axis(x, mesh, ("dp", "tp")))
    run("ppermute", lambda x: par.ppermute_grad(x, mesh, "tp",
                                                [(0, 1), (1, 0)]))


def check_moe_mesh(R, mx, par):
    """``moe_ffn`` over {dp: 2, tp: 2} with the experts over tp: this
    rank's rows of the output, the aux loss, and the gradients of
    ``sum(out ** 2) + 0.01 * aux`` (summed over dp; this rank's experts
    for w1/w2, its rows for x)."""
    import torch
    mesh = par.create_mesh({"dp": 2, "tp": 2})
    x, gw, w1, w2 = moe_data()
    d, t = mesh.axis_index("dp"), mesh.axis_index("tp")
    ts = [torch.from_numpy(a.copy()).requires_grad_(True)
          for a in (x[2 * d:2 * d + 2], gw, w1[2 * t:2 * t + 2],
                    w2[2 * t:2 * t + 2])]
    out, aux = par.moe_ffn(*ts, k=2, capacity_factor=MOE_CAPACITY_FACTOR,
                           mesh=mesh, ep_axis="tp")
    R.put("moe/out", _np(out))
    R.put("moe/aux", float(aux))
    ((out ** 2).sum() + 0.01 * aux).backward()
    R.put("moe/dx", _np(ts[0].grad))
    for name, t_ in zip(("dgw", "dw1", "dw2"), ts[1:]):
        R.put("moe/" + name, _np(par.all_reduce(t_.grad, mesh, "dp")))


def _sp_train(R, mx, par, mesh, kind, key):
    from mxnet_tpu_torch import gluon
    net = sp_net(mx, kind)
    tr = par.DistributedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                mesh, optimizer="sgd",
                                optimizer_params={"learning_rate": SP_LR})
    R.put(key + "/losses", np.array([float(tr.fit_batch(
        mx.nd.array(x), mx.nd.array(y)).asnumpy())
        for x, y in sp_batches(kind)]))
    tr.sync_gluon_params()
    for i, (_, p) in enumerate(sorted(net.collect_params().items())):
        R.put("%s/p%d" % (key, i), p.data().asnumpy())


def check_sp_trainer(R, mx, par):
    """The DistributedTrainer over {dp: 2, sp: 2} (each rank its rows
    and its half of the sequence), both sp nets, SGD; with FSDP and
    ZeRO-1 over dp too."""
    mesh = par.create_mesh({"dp": 2, "sp": 2})
    for kind in ("probe", "positioned"):
        _sp_train(R, mx, par, mesh, kind, "sp/" + kind)
    from mxnet_tpu_torch import gluon
    tr = par.DistributedTrainer(sp_net(mx, "probe"),
                                gluon.loss.SoftmaxCrossEntropyLoss(), mesh,
                                optimizer="sgd",
                                optimizer_params={"learning_rate": SP_LR},
                                grad_overlap=True, param_shard=True)
    R.put("sp/fsdp/losses", np.array([float(tr.fit_batch(
        mx.nd.array(x), mx.nd.array(y)).asnumpy())
        for x, y in sp_batches("probe")]))
    try:
        tr2 = par.DistributedTrainer(
            tp_net(mx), gluon.loss.SoftmaxCrossEntropyLoss(), mesh)
        tr2.fit_batch(mx.nd.array(np.zeros((4, TP_WIDTH), np.float32)),
                      mx.nd.array(np.zeros((4,), np.float32)))
        R.put("sp/no_seq", "")
    except Exception as exc:
        R.put("sp/no_seq", str(exc))


def check_sp_dp_step(R, mx, par):
    """make_data_parallel_step over {dp: 2, sp: 2} on per-token data."""
    import torch
    mesh = par.create_mesh({"dp": 2, "sp": 2})
    for overlap in (False, True):
        step, bsh = par.make_data_parallel_step(
            lambda p, b: ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).mean(),
            mesh, optimizer_update=lambda p, g: p - 0.1 * g,
            grad_overlap=overlap, bucket_mb=1e-6)
        params = {"w": torch.zeros(4, 1), "b": torch.zeros(1)}
        losses = []
        for x, y in sp_step_data():
            loss, params = step(params, {"x": x, "y": y})
            losses.append(float(loss))
        key = "sp_step/%d" % overlap
        R.put(key + "/losses", np.array(losses))
        R.put(key + "/w", _np(params["w"]))
        R.put(key + "/b", _np(params["b"]))
    R.put("sp_step/spec", list(bsh.spec))


def tp_run(mx, par, mesh, shard, steps=3):
    from mxnet_tpu_torch import gluon
    net = tp_net(mx)
    tr = par.DistributedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                                mesh, optimizer="adam",
                                optimizer_params={"learning_rate": 0.01},
                                param_shard=shard)
    losses = [float(tr.fit_batch(mx.nd.array(x), mx.nd.array(y)).asnumpy())
              for x, y in dist_batches(steps, width=TP_WIDTH)]
    return net, tr, np.array(losses)


def check_tp_trainer(R, mx, par):
    """The tp probe over {dp: 2, tp: 2}, Adam: with param_shard the 2-D
    shards at rest (this rank's piece of each, its bytes, its optimizer
    state); without it, tp places nothing. The weights after the run."""
    mesh = par.create_mesh({"dp": 2, "tp": 2})
    for shard in (True, False):
        net, tr, losses = tp_run(mx, par, mesh, shard)
        key = "tp/%d" % shard
        R.put(key + "/losses", losses)
        R.put(key + "/bytes", tr.param_bytes_per_device())
        R.put(key + "/state_bytes", tr.state_bytes_per_device())
        R.put(key + "/breakdown", tr._memory_breakdown())
        if shard:
            R.put(key + "/roster", list(tr._roster))
            R.put(key + "/specs", [list(pl.spec) for pl in tr._param_plans])
            for name, v in zip(tr._roster, tr._param_vals):
                R.put("%s/local/%s" % (key, name), _np(v))
            try:
                tr.save_checkpoint(os.path.join(R.cfg["tmp"], "tp"), 0)
                R.put(key + "/ckpt", "")
            except NotImplementedError as exc:
                R.put(key + "/ckpt", str(exc))
        tr.sync_gluon_params()
        for i, (_, p) in enumerate(sorted(net.collect_params().items())):
            R.put("%s/p%d" % (key, i), p.data().asnumpy())


def check_tp_reference(R, mx, par):
    """The tp probe over {dp: 2} with param_shard: the run the {dp: 2,
    tp: 2} one must equal."""
    net, tr, losses = tp_run(mx, par, par.local_mesh("dp"), True)
    R.put("tp_ref/losses", losses)
    tr.sync_gluon_params()
    for i, (_, p) in enumerate(sorted(net.collect_params().items())):
        R.put("tp_ref/p%d" % i, p.data().asnumpy())


SUITES = {
    "parallel": (check_mesh, check_collectives, check_attention,
                 check_attention_op, check_dp_step),
    "pipeline": (check_pipeline,),
    "parallel4": (check_attention4,),
    "pipeline_moe": (check_pipeline_apply, check_pipeline_n_micro,
                     check_moe_mesh, check_autograd_collectives),
    "sp_trainer": (check_sp_trainer, check_sp_dp_step),
    "tp_trainer": (check_tp_trainer,),
    "data_parallel": (check_bitexact, check_zero1, check_placed_once,
                      check_unknown_optimizer, check_checkpoint,
                      check_cross_load, check_seed_export, check_telemetry,
                      check_batchnorm),
    "param_shard": (check_fsdp, check_fsdp_checkpoint, check_cross_load,
                    check_fsdp_dp_step, check_make_mesh, check_shard_params,
                    check_telemetry, check_tp_reference),
}


def main(argv):
    suite, store, rank, world, cfg_path, out = argv
    rank, world = int(rank), int(world)
    import torch
    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch.parallel import distributed
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg.setdefault("tmp", os.path.dirname(cfg_path))
    distributed.init("file://" + store, world, rank)
    R = Rank(rank, world, cfg)
    for fn in SUITES[suite]:
        R.check(fn.__name__, lambda fn=fn: fn(R, mx, par))
        distributed.barrier()
    R.save(out)
    distributed.barrier()
    print("RANK_OK %d" % rank, flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
