"""Standalone deploy artifacts — the ``c_predict_api`` of the port
(counterpart of ``mxnet_tpu/deploy.py``).

Reference deploy story: ``HybridBlock.export`` emits symbol.json +
params, which the standalone C predict ABI (src/c_api/c_predict_api.cc)
loads without the Python framework. Here ``export_compiled`` traces the
model's predict-mode forward through ``torch.export`` into ONE file that
a process importing only torch can run, and ``load_compiled`` loads it:

    mx.deploy.export_compiled(net, "model.mxp",
                              input_shapes={"data": (1, 3, 224, 224)},
                              batch_sizes=[1, 2, 4, 8])
    pred = mx.deploy.load_compiled("model.mxp")        # on cuda:0
    probs = pred(x)                      # numpy in, numpy out

The JAX package's artifact holds StableHLO programs (``jax.export``),
which torch cannot run: :func:`load_compiled` refuses one with an
:class:`MXNetError` saying so. This port's artifact holds
``torch.export`` programs. The layout is the JAX package's: ``MAGIC`` +
meta length + meta JSON + the program blobs back to back, one a bucket
batch size. The meta's ``format``, ``inputs``, ``outputs`` and
``programs`` (bucket batches and output shapes) equal the JAX
package's for the same model; ``framework`` is ``mxnet_tpu_torch``,
``runtime`` is ``torch.export`` and ``torch`` its version.

- **Programs.** Each blob is a ``torch.export.save`` of one bucket's
  forward: the plan's output heads in predict mode, the parameters and
  auxiliary states inside as buffers. Their values are stored ONCE, in
  a weight block after the programs (a ``torch.save`` of the buffer
  dict, ``meta["weights"]``); each blob carries them as ``meta``-device
  placeholders. A process with torch alone runs a bucket's program by
  ``torch.export.load`` of its blob, ``torch.load`` of the weight block
  into the program's ``state_dict``, then ``.module()``.
- **Devices.** Export traces on the device the parameters live on.
  ``load_compiled(path, device=None)`` moves every program to the
  caller's device (default: the current context's, ``cuda:0``) with
  ``torch.export.passes.move_to_device_pass``, so an artifact exported
  on the CPU serves on the card, and the reverse.
- **Calls.** :class:`Predictor` validates every call against the
  recorded signature (argument count, non-batch dims, dtype) and runs a
  batch of ``b`` rows on the smallest bucket ``>= b`` (zero-pad rows
  in, slice rows back out — exact, a row's result never depends on its
  batch-mates); ``serving.InferenceServer`` serves the same ladder.
- **Attention.** A graph holding ``_contrib_flash_attention`` or
  ``_contrib_decode_attention`` traces into op nodes of the
  ``mxnet_tpu_torch`` namespace (``flash_fwd``, ``flash_decode``: the
  hand-written kernels as ``torch.library`` ops, see
  ``parallel.flash_attention``), on the CPU or on the card alike. The
  meta's ``custom_ops`` names the ops the programs hold. Such an
  artifact needs more than torch to load: the port importable, which
  registers the ops, and its kernel sources, which build at the first
  launch on the card. :func:`load_compiled` imports the ops before
  ``torch.export.load`` and refuses, with an :class:`MXNetError` naming
  them, ops it does not know. A program exported on the CPU and moved to
  the card launches the kernels there.
- **Format 3 (int8).** ``export_compiled(quantize=True,
  calib_data=...)`` calibrates per-node ranges (naive min/max),
  rewrites eligible FullyConnected/Convolution nodes through
  ``contrib.quantization.quantize_symbol`` into quantize -> quantized op
  -> requantize -> dequantize chains over ``ops.quantization`` (int8 x
  int8 -> int32, cuBLASLt's int8 GEMM on the card), replays the
  calibration batches through both graphs, and exports the int8 graph.
  The quantized ops are ``torch.library`` ops too (one node each, see
  ``ops.quantization``), so an int8 artifact names them in
  ``custom_ops`` and loads where the port is importable.
  The meta's ``quantization`` block records the JAX package's keys:
  the ranges, the exclusions, the measured ``max_abs_delta`` and the
  tolerance, ``max_output_delta``, over which export raises.
  :attr:`Predictor.quantization` returns the block.
"""
from __future__ import annotations

import io
import json
import os
import struct

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["export_compiled", "load_compiled", "Predictor",
           "check_cast_dtype"]

_MAGIC = b"MXTPUDEPLOY1"


def _dtype_name(dtype):
    return str(dtype).replace("torch.", "")


def _tensor(value, device):
    data = value._data if hasattr(value, "_data") else value
    return torch.as_tensor(_np.asarray(data) if not isinstance(
        data, torch.Tensor) else data, device=device).detach()


class _Forward(torch.nn.Module):
    """A Symbol's plan in predict mode over its data inputs, the
    parameters and auxiliary states inside as buffers ``w0, w1, ...``;
    returns the ``n_out`` heads."""

    def __init__(self, symbol, arg_params, aux_params, data_names,
                 device):
        super().__init__()
        from .cached_op import build_graph_callable
        fn, arg_names, aux_names, _n_rng, n_out = \
            build_graph_callable(symbol)
        self._fn = fn
        self._n_out = n_out
        self._data_names = list(data_names)
        self._slots = []             # ("data", i) or ("w", buffer name)
        k = 0
        for n in arg_names + aux_names:
            if n in self._data_names:
                self._slots.append(("data", self._data_names.index(n)))
                continue
            value = arg_params[n] if n in arg_params else aux_params[n]
            name = "w%d" % k
            k += 1
            self.register_buffer(name, _tensor(value, device))
            self._slots.append(("w", name))

    def forward(self, *data):
        vals = [data[ref] if kind == "data" else getattr(self, ref)
                for kind, ref in self._slots]
        outs = self._fn({"__train__": False}, *vals)[:self._n_out]
        return outs[0] if self._n_out == 1 else tuple(outs)


def check_cast_dtype(name, arr, dtype_str, who="Predictor"):
    """The one dtype gate for artifact-described inputs (shared by
    :class:`Predictor` and ``serving.InferenceServer``): a
    ``same_kind`` cast is applied silently, anything else raises a
    descriptive error naming the input."""
    if dtype_str and str(arr.dtype) != dtype_str:
        if not _np.can_cast(arr.dtype, _np.dtype(dtype_str),
                            casting="same_kind"):
            raise MXNetError(
                "%s: input %r dtype %s cannot safely cast to the "
                "artifact's recorded %s"
                % (who, name, arr.dtype, dtype_str))
        arr = arr.astype(_np.dtype(dtype_str), copy=False)
    return arr


def _out_meta(ep):
    """Output shapes/dtypes of an exported program, from its graph."""
    node = next(n for n in ep.graph.nodes if n.op == "output")
    vals = [a.meta["val"] for a in node.args[0]]
    return [{"shape": [int(s) for s in v.shape],
             "dtype": _dtype_name(v.dtype)} for v in vals]


def _custom_ops(ep):
    """The ``mxnet_tpu_torch`` ops an exported program's graph calls."""
    return {n.target.name() for n in ep.graph.nodes
            if n.op == "call_function"
            and isinstance(n.target, torch._ops.OpOverload)
            and n.target.namespace == "mxnet_tpu_torch"}


def _batch_arrays(batch):
    """Numpy data arrays of one calibration batch (DataBatch-style
    ``.data`` list, or a bare array)."""
    datas = batch.data if hasattr(batch, "data") else [batch]
    return [_np.asarray(d.asnumpy() if hasattr(d, "asnumpy") else d)
            for d in datas]


def _max_output_delta(fp32_fn, q_fn, calib_data, num_calib_batches,
                      n_inputs, device):
    """Replay calibration batches through both graphs; the largest
    absolute elementwise output difference is the artifact's recorded
    quantization accuracy delta."""
    delta, batches = 0.0, 0
    for batch in calib_data:
        xs = [torch.from_numpy(_np.ascontiguousarray(x)).to(device)
              for x in _batch_arrays(batch)[:n_inputs]]
        with torch.no_grad():
            ref, got = fp32_fn(*xs), q_fn(*xs)
        ref = ref if isinstance(ref, tuple) else (ref,)
        got = got if isinstance(got, tuple) else (got,)
        for r, g in zip(ref, got):
            d = torch.max(torch.abs(g.to(torch.float32)
                                    - r.to(torch.float32)))
            delta = max(delta, float(d))
        batches += 1
        if num_calib_batches and batches >= num_calib_batches:
            break
    if hasattr(calib_data, "reset"):
        calib_data.reset()
    return delta, batches


def _quantized(symbol, arg_params, aux, data_names, device, calib_data,
               num_calib_batches, excluded_sym_names, max_output_delta):
    """Format 3's int8 graph and its meta block (the JAX package's
    keys): naive calibration, the rewrite, the accuracy delta over the
    calibration batches, checked against ``max_output_delta``."""
    from .contrib import quantization as _quant
    if calib_data is None:
        raise MXNetError(
            "export_compiled: quantize=True requires calib_data "
            "(a re-iterable batch source) for range calibration "
            "and the accuracy-delta oracle")
    ranges = _quant.calibrate_ranges(
        symbol, arg_params, aux, calib_data,
        num_calib_batches=num_calib_batches, data_name=data_names[0])
    qsym = _quant.quantize_symbol(
        symbol, excluded_symbols=set(excluded_sym_names),
        calib_ranges=ranges)
    q_names = [n for n in qsym.list_arguments() if n not in arg_params]
    if q_names != data_names:
        raise MXNetError(
            "export_compiled: quantized graph changed the data "
            "inputs %s -> %s" % (data_names, q_names))
    delta, batches = _max_output_delta(
        _Forward(symbol, arg_params, aux, data_names, device),
        _Forward(qsym, arg_params, aux, data_names, device), calib_data,
        num_calib_batches, len(data_names), device)
    if max_output_delta is not None and delta > max_output_delta:
        raise MXNetError(
            "export_compiled: int8 quantization moved an output "
            "element by %.6g — beyond the max_output_delta %.6g "
            "tolerance; widen the tolerance, exclude the worst "
            "layers (excluded_sym_names), or calibrate on more "
            "representative data" % (delta, max_output_delta))
    return qsym, {
        "dtype": "int8",
        "calib_mode": "naive",
        "calib_batches": batches,
        "ranges": {n: [float(lo), float(hi)]
                   for n, (lo, hi) in sorted(ranges.items())},
        "excluded": sorted(excluded_sym_names),
        "max_abs_delta": delta,
        "tolerance": max_output_delta,
    }


def export_compiled(model, path, input_shapes, params=None,
                    aux_params=None, dtype="float32", batch_sizes=None,
                    quantize=False, calib_data=None,
                    num_calib_batches=None, excluded_sym_names=(),
                    max_output_delta=None):
    """Serialize ``model`` (a hybridized Gluon block that has run one
    forward, or a Symbol plus ``params``/``aux_params`` dicts) into one
    artifact file of ``torch.export`` programs, traced on the device
    the parameters live on.

    ``batch_sizes`` (optional) exports one program per bucket batch
    size — a multi-signature artifact whose leading input dim is each
    bucket in turn (the serving bucket ladder). Without it, one
    program with exactly ``input_shapes`` is exported.

    A graph holding the attention ops exports their ``torch.library``
    op nodes (the meta's ``custom_ops``), traced on the CPU or the card;
    so does an int8 graph its quantized ops.

    ``quantize=True`` writes a **format-3 int8 artifact**: the graph is
    calibrated on ``calib_data`` (required; naive min/max over
    ``num_calib_batches``), rewritten through
    ``contrib.quantization.quantize_symbol`` (``excluded_sym_names``
    opts nodes out), and the exported programs ARE the quantized graph.
    The meta's ``quantization`` block records the ranges and the
    measured ``max_abs_delta`` between the fp32 and int8 outputs over
    the calibration batches; with ``max_output_delta`` set, export
    raises :class:`MXNetError` instead of shipping an artifact whose
    quantization error exceeds the tolerance."""
    from . import symbol as sym_mod

    if isinstance(model, sym_mod.Symbol):
        symbol = model
        arg_params = dict(params or {})
        aux = dict(aux_params or {})
    else:                                  # Gluon HybridBlock
        if not getattr(model, "_cached_graph", None):
            raise MXNetError(
                "export_compiled: hybridize() the block and run one "
                "forward before exporting")
        symbol = model._cached_graph[1]
        arg_names = set(symbol.list_arguments())
        aux_names = set(symbol.list_auxiliary_states())
        arg_params, aux = {}, {}
        for name, p in model.collect_params().items():
            if name in arg_names:
                arg_params[name] = p.data()
            elif name in aux_names:
                aux[name] = p.data()
    data_names = [n for n in symbol.list_arguments()
                  if n not in arg_params]
    missing = [n for n in data_names if n not in input_shapes]
    if missing:
        raise MXNetError(
            "export_compiled: provide input_shapes for %s" % missing)
    device = _param_device(arg_params, aux)
    quant_meta = None
    if quantize:
        symbol, quant_meta = _quantized(
            symbol, arg_params, aux, data_names, device, calib_data,
            num_calib_batches, excluded_sym_names, max_output_delta)
    forward = _Forward(symbol, arg_params, aux, data_names, device)
    if batch_sizes is not None:
        buckets = sorted({int(b) for b in batch_sizes})
        if not buckets or buckets[0] < 1:
            raise MXNetError(
                "export_compiled: batch_sizes must be positive ints, "
                "got %r" % (batch_sizes,))
    else:
        buckets = [None]
    tdtype = getattr(torch, str(dtype))
    programs, blobs, weights, custom_ops = [], [], None, set()
    for b in buckets:
        shapes = []
        for n in data_names:
            shape = tuple(int(s) for s in input_shapes[n])
            if b is not None:
                if not shape:
                    raise MXNetError(
                        "export_compiled: input %r is a scalar — "
                        "batch_sizes needs a leading batch dim" % n)
                shape = (int(b),) + shape[1:]
            shapes.append(shape)
        example = tuple(torch.zeros(s, dtype=tdtype, device=device)
                        for s in shapes)
        with torch.no_grad():
            ep = torch.export.export(forward, example, strict=False)
        if b is None:
            shape0 = tuple(input_shapes[data_names[0]])
            b = int(shape0[0]) if shape0 else 1
        if weights is None:
            weights = {k: v.detach().cpu()
                       for k, v in ep.state_dict.items()}
        # the values live once, in the weight block; the example
        # inputs (zeros of the bucket's shape) are not kept
        for k in list(ep.state_dict):
            ep.state_dict[k] = ep.state_dict[k].to("meta")
        ep.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(ep, buf)
        programs.append((int(b), _out_meta(ep)))
        blobs.append(buf.getvalue())
        custom_ops |= _custom_ops(ep)
    wbuf = io.BytesIO()
    torch.save(weights, wbuf)
    wblob = wbuf.getvalue()
    meta = {
        "format": 3 if quant_meta else 2,
        "inputs": [{"name": n, "shape": list(input_shapes[n]),
                    "dtype": str(dtype)} for n in data_names],
        "outputs": programs[0][1],
        "programs": [{"batch": b, "length": len(blob), "outputs": outs}
                     for (b, outs), blob in zip(programs, blobs)],
        "framework": "mxnet_tpu_torch",
        "runtime": "torch.export",
        "torch": torch.__version__,
        "weights": {"length": len(wblob)},
        "custom_ops": sorted(custom_ops),
    }
    if quant_meta:
        meta["quantization"] = quant_meta
    meta_bytes = json.dumps(meta).encode()
    # tmp + os.replace: a preempted export leaves any previous artifact
    # intact, never a truncated one a serving replica could load
    tmp = path + ".tmp"
    with open(tmp, "wb") as sink:
        sink.write(b"".join([_MAGIC, struct.pack("<I", len(meta_bytes)),
                             meta_bytes] + blobs + [wblob]))
    os.replace(tmp, path)
    return path


def _param_device(arg_params, aux):
    for v in list(arg_params.values()) + list(aux.values()):
        data = v._data if hasattr(v, "_data") else v
        if isinstance(data, torch.Tensor):
            return data.device
    return torch.device("cpu")


def _program_devices(ep):
    """Every device an exported program names: its state and constants,
    and the ``device=`` of the ops in its graph."""
    out = {str(t.device) for t in ep.state_dict.values()}
    out |= {str(t.device) for t in ep.constants.values()
            if isinstance(t, torch.Tensor)}
    for node in ep.graph.nodes:
        dev = node.kwargs.get("device") if node.op == "call_function" \
            else None
        if dev is not None:
            out.add(str(torch.device(dev)))
    return out


class Predictor:
    """Callable wrapper over a loaded deploy artifact (the
    c_predict_api MXPredCreate/MXPredForward role): numpy (or NDArray)
    in, numpy out.

    Calls are validated against the artifact meta — argument count,
    per-input non-batch dims, dtype — and a batch of ``b`` rows runs on
    the smallest exported bucket ``>= b`` (rows zero-padded in, sliced
    back out; exact). A call that cannot match any recorded signature
    raises a descriptive :class:`MXNetError`."""

    def __init__(self, programs, meta, device):
        self._programs = sorted(programs, key=lambda p: p[0])
        self.meta = meta
        self.device = torch.device(device)
        self._modules = {}          # (bucket, device) -> module

    @property
    def input_names(self):
        return [i["name"] for i in self.meta["inputs"]]

    @property
    def batch_sizes(self):
        """The exported bucket ladder (ascending)."""
        return [b for b, _ in self._programs]

    @property
    def output_info(self):
        """Recorded output shapes/dtypes (None on format-1 artifacts
        that predate the field)."""
        return self.meta.get("outputs")

    @property
    def quantization(self):
        """The format-3 quantization block — calibration ranges,
        measured ``max_abs_delta``, exclusions — or None on an fp32
        artifact."""
        return self.meta.get("quantization")

    def program_devices(self):
        """Every device the loaded programs name (state, constants and
        ops' ``device=``): after loading, only the predictor's."""
        out = set()
        for _b, ep in self._programs:
            out |= _program_devices(ep)
        return out

    # -- validation --------------------------------------------------------
    def _validate(self, arrays):
        """Check ``arrays`` against the artifact meta; returns the
        shared batch size (None when the meta records no shapes)."""
        inputs = self.meta.get("inputs") or []
        if inputs and len(arrays) != len(inputs):
            raise MXNetError(
                "Predictor: artifact takes %d input(s) %s, got %d "
                "argument(s)" % (len(inputs),
                                 [i.get("name") for i in inputs],
                                 len(arrays)))
        batch = None
        for spec, arr in zip(inputs, arrays):
            name = spec.get("name", "?")
            want = [int(s) for s in (spec.get("shape") or [])]
            if want:
                got = list(arr.shape)
                if len(got) != len(want):
                    raise MXNetError(
                        "Predictor: input %r has rank %d, artifact "
                        "recorded shape %s (rank %d)"
                        % (name, len(got), want, len(want)))
                if got[1:] != want[1:]:
                    raise MXNetError(
                        "Predictor: input %r non-batch dims %s do not "
                        "match the artifact's recorded %s"
                        % (name, got[1:], want[1:]))
                if batch is None:
                    batch = got[0]
                elif got[0] != batch:
                    raise MXNetError(
                        "Predictor: inconsistent batch dims — input "
                        "%r has %d rows where earlier inputs had %d"
                        % (name, got[0], batch))
            check_cast_dtype(name, arr, spec.get("dtype"))
        return batch

    def _cast(self, arrays):
        inputs = self.meta.get("inputs") or []
        return [check_cast_dtype(inputs[i].get("name", "?"), arr,
                                 inputs[i].get("dtype"))
                if i < len(inputs) else arr
                for i, arr in enumerate(arrays)]

    def bucket_for(self, batch):
        """The smallest exported bucket ``>= batch``; raises a
        descriptive error past the ladder's top."""
        from .serving.batcher import BucketLadder
        b = BucketLadder(self.batch_sizes).bucket_for(batch)
        if b is None:
            raise MXNetError(
                "Predictor: batch %d exceeds the largest exported "
                "bucket %d (ladder %s) — re-export with a bigger "
                "bucket or split the call"
                % (batch, self._programs[-1][0], self.batch_sizes))
        return b

    def program(self, bucket, device=None):
        """The program for an exact bucket size as a callable over torch
        tensors on ``device`` (default: the predictor's), moved there
        once and kept."""
        device = self.device if device is None else torch.device(device)
        key = (bucket, str(device))
        mod = self._modules.get(key)
        if mod is not None:
            return mod
        for b, ep in self._programs:
            if b == bucket:
                if device != self.device:
                    from torch.export.passes import move_to_device_pass
                    ep = move_to_device_pass(ep, device)
                mod = self._modules[key] = ep.module()
                return mod
        raise MXNetError("Predictor: no program for bucket %d "
                         "(ladder %s)" % (bucket, self.batch_sizes))

    # -- prediction --------------------------------------------------------
    def __call__(self, *args):
        arrays = [a.asnumpy() if hasattr(a, "asnumpy")
                  else _np.asarray(a) for a in args]
        batch = self._validate(arrays)
        arrays = self._cast(arrays)
        if batch is None:                  # shape-less legacy meta
            bucket = self._programs[0][0]
        else:
            bucket = self.bucket_for(batch)
            if bucket != batch:
                arrays = [_np.concatenate(
                    [a, _np.zeros((bucket - batch,) + a.shape[1:],
                                  dtype=a.dtype)]) for a in arrays]
        with torch.inference_mode():
            out = self.program(bucket)(*[
                torch.from_numpy(_np.ascontiguousarray(a)).to(self.device)
                for a in arrays])
            single = not isinstance(out, (tuple, list))
            outs = [o.cpu().numpy() for o in ([out] if single else out)]
        if batch is not None and bucket != batch:
            outs = [o[:batch] for o in outs]
        return outs[0] if single else tuple(outs)

    predict = __call__


def _load_program(blob, weights, device):
    """One bucket's exported program: its weights filled in from the
    weight block where the blob holds placeholders, moved to
    ``device``."""
    import logging
    from torch.export.passes import move_to_device_pass
    # the placeholders hold no bytes, which torch's loader logs per
    # buffer before it fills them with zeros; the weights replace them
    log = logging.getLogger("torch.export.pt2_archive._package")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        ep = torch.export.load(io.BytesIO(blob))
    finally:
        log.setLevel(level)
    for k, v in list(ep.state_dict.items()):
        if v.device.type == "meta":
            if weights is None or k not in weights:
                raise MXNetError("deploy artifact: no weights for %r" % k)
            ep.state_dict[k] = weights[k]
    return move_to_device_pass(ep, device)


def _check_custom_ops(path, meta):
    """Register the port's ops (importing their modules builds nothing)
    and refuse an artifact naming ops this loader does not know."""
    from .ops import quantization
    from .parallel import flash_attention
    unknown = sorted(set(meta.get("custom_ops") or ())
                     - set(flash_attention.OPS) - set(quantization.OPS))
    if unknown:
        raise MXNetError(
            "%s holds ops this mxnet_tpu_torch does not register: %s — "
            "load it with the mxnet_tpu_torch that exported it"
            % (path, ", ".join(unknown)))


def load_compiled(path, device=None):
    """Load an ``export_compiled`` artifact (format 1, 2 or 3 — a
    format-3 file reads as format 2 whose programs run the int8 graph)
    onto ``device`` (default: the current context's device, ``cuda:0``).
    Needs torch alone — not the framework's model code or parameter
    files — except for an artifact whose meta names ``custom_ops``
    (attention, int8): that needs this package, whose ops are registered
    here before the programs load, and for attention its kernel sources
    on the card. A JAX-package artifact (StableHLO) is refused."""
    from .context import resolve_device
    device = resolve_device(device)
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise MXNetError("%s is not a mxnet_tpu deploy artifact"
                             % path)
        (mlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(mlen).decode())
        if meta.get("framework") == "mxnet_tpu":
            raise MXNetError(
                "%s was exported by the JAX package: it holds StableHLO "
                "programs (jax.export), which torch cannot run — export "
                "the model with mxnet_tpu_torch.deploy.export_compiled"
                % path)
        _check_custom_ops(path, meta)
        if meta.get("format", 1) >= 2 and meta.get("programs"):
            blobs = []
            for p in meta["programs"]:
                blob = f.read(int(p["length"]))
                if len(blob) != int(p["length"]):
                    raise MXNetError(
                        "%s is truncated: program for bucket %s is "
                        "short" % (path, p.get("batch")))
                blobs.append((int(p["batch"]), blob))
            weights = None
            if meta.get("weights"):
                wlen = int(meta["weights"]["length"])
                wblob = f.read(wlen)
                if len(wblob) != wlen:
                    raise MXNetError("%s is truncated: the weight block "
                                     "is short" % path)
                weights = torch.load(io.BytesIO(wblob),
                                     map_location=device,
                                     weights_only=True)
        else:                              # format 1: one trailing blob
            shape0 = (meta.get("inputs") or [{}])[0].get("shape") or []
            blobs = [(int(shape0[0]) if shape0 else 1, f.read())]
            weights = None
    programs = [(b, _load_program(blob, weights, device))
                for b, blob in blobs]
    return Predictor(programs, meta, device)
