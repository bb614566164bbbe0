"""Checkpoint manifests, the read half (counterpart of
``mxnet_tpu/checkpoint.py``).

A manifest checkpoint is a JSON file ``<prefix>-<epoch>.ckpt.json``
that names every artifact of one save with its SHA-256 (shard files of
npz payloads, an optimizer-state sibling) and every parameter's layout
(shape, dtype, and its pieces: shard, key, and the global index of a
piece of a sharded entry). Shard 0 is ``<prefix>-<epoch>.params``, the
single-file format ``nd.load`` reads. Loading checks each file against
its checksum before it parses it, so a torn write raises
:class:`~mxnet_tpu_torch.base.MXNetError` naming the file, and
re-assembles a sharded entry from its pieces on the host.

A bfloat16 entry comes back from npz as raw 2-byte values (``|V2``);
numpy has no bfloat16 dtype without ``ml_dtypes``, so the port
reinterprets those bytes as ``torch.bfloat16``, bit for bit.

The writer (``CheckpointManager``, ``save_arrays``) is not ported yet
(ROADMAP queue A item 10).
"""
from __future__ import annotations

import glob
import hashlib
import io as _io
import json
import logging
import os
import re

import numpy as np
import torch

from .base import MXNetError
from .ndarray.ndarray import tensor_from_numpy

__all__ = ["manifest_path", "load_manifest", "validate_manifest",
           "latest_manifest_epoch", "load_arrays", "load_param_arrays"]

_PIECE_SEP = "::piece"       # shard-file key suffix for partial pieces


def _tag(prefix, epoch):
    return "%s-%04d" % (prefix, int(epoch))


def manifest_path(prefix, epoch):
    return _tag(prefix, epoch) + ".ckpt.json"


def _sha256(payload):
    return hashlib.sha256(payload).hexdigest()


def latest_manifest_epoch(prefix, validate=True):
    """The newest epoch under ``prefix`` whose manifest (and, with
    ``validate``, every artifact it references) checks out; torn or
    corrupt epochs are skipped with a warning. None when nothing usable
    exists."""
    base = os.path.basename(prefix)
    dirname = os.path.dirname(prefix) or "."
    # \d{4,}: '%04d' grows past four digits at epoch 10000
    pat = re.compile(re.escape(base) + r"-(\d{4,})\.ckpt\.json$")
    epochs = []
    for path in glob.glob(os.path.join(dirname, base + "-*.ckpt.json")):
        m = pat.match(os.path.basename(path))
        if m:
            epochs.append(int(m.group(1)))
    for epoch in sorted(epochs, reverse=True):
        try:
            if validate:
                validate_manifest(prefix, epoch)
            elif load_manifest(prefix, epoch) is None:
                continue
            return epoch
        except (MXNetError, ValueError, OSError) as exc:
            logging.getLogger(__name__).warning(
                "checkpoint scan: epoch %04d under %s is torn/corrupt "
                "(%s) — skipping", epoch, prefix, exc)
    return None


def load_manifest(prefix, epoch):
    """The parsed manifest for ``(prefix, epoch)``, or None when the
    epoch has none (a single-file checkpoint)."""
    path = manifest_path(prefix, epoch)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _read_entry(prefix, epoch, entry, validate=True):
    """One artifact's bytes, after checking that it exists and (with
    ``validate``) matches its recorded SHA-256; raises naming the
    missing or torn file."""
    base = os.path.dirname(_tag(prefix, epoch))
    path = os.path.join(base, entry["file"]) if base else entry["file"]
    if not os.path.isfile(path):
        raise MXNetError("checkpoint %s: missing artifact %s"
                         % (_tag(prefix, epoch), entry["file"]))
    with open(path, "rb") as f:
        payload = f.read()
    if validate and _sha256(payload) != entry["sha256"]:
        raise MXNetError("checkpoint %s: artifact %s is torn/corrupt "
                         "(checksum mismatch)"
                         % (_tag(prefix, epoch), entry["file"]))
    return payload


def validate_manifest(prefix, epoch, manifest=None):
    """Check every artifact the manifest references (shards and the
    optimizer-state sibling) against its SHA-256; raises naming the torn
    file, returns the manifest."""
    manifest = manifest if manifest is not None \
        else load_manifest(prefix, epoch)
    if manifest is None:
        raise MXNetError("no manifest for %s" % _tag(prefix, epoch))
    entries = list(manifest["shards"])
    if manifest.get("optimizer_states") is not None:
        entries.append(manifest["optimizer_states"])
    for entry in entries:
        _read_entry(prefix, epoch, entry)
    return manifest


def _restore_dtype(arr, entry):
    """A CPU tensor of one loaded array in its manifest dtype: raw
    2-byte values recorded as bfloat16 are reinterpreted bit for bit;
    another recorded dtype of the same width is a numpy view."""
    want = entry.get("dtype")
    if want and want != "bfloat16" and str(arr.dtype) != want:
        dt = np.dtype(want)
        arr = arr.view(dt) if arr.dtype.itemsize == dt.itemsize \
            else arr.astype(dt)
    out = tensor_from_numpy(arr)
    if want == "bfloat16" and out.dtype != torch.bfloat16:
        raise MXNetError("checkpoint entry recorded as bfloat16 holds %s"
                         % arr.dtype)
    return out


_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32}


def _read_host(prefix, epoch, validate):
    """``{key: CPU tensor}`` of a manifest checkpoint, sharded entries
    re-assembled from their pieces; float64 and int64 entries come back
    as float32 and int32, as the JAX package's ``nd.array`` gives them."""
    manifest = load_manifest(prefix, epoch)
    if manifest is None:
        raise MXNetError("no manifest for %s" % _tag(prefix, epoch))
    shard_data = []
    for entry in manifest["shards"]:
        payload = _read_entry(prefix, epoch, entry, validate=validate)
        shard_data.append(dict(np.load(_io.BytesIO(payload),
                                       allow_pickle=False)))
    if validate and manifest.get("optimizer_states") is not None:
        _read_entry(prefix, epoch, manifest["optimizer_states"])
    out = {}
    for key, entry in manifest["params"].items():
        pieces = entry["pieces"]
        if key.startswith(("__sparse_csr__::", "__sparse_rsp__::")) \
                or "shape" not in entry:
            raise NotImplementedError(
                "checkpoint %s: sparse entry %s needs ndarray/sparse.py, "
                "not ported yet (ROADMAP queue A item 13)"
                % (_tag(prefix, epoch), key))
        if len(pieces) == 1 and pieces[0]["index"] is None:
            out[key] = _restore_dtype(
                shard_data[pieces[0]["shard"]][pieces[0]["key"]], entry)
            continue
        full = None
        for p in pieces:
            part = _restore_dtype(shard_data[p["shard"]][p["key"]], entry)
            if full is None:
                full = torch.empty(tuple(entry["shape"]), dtype=part.dtype)
            full[tuple(slice(a, b) for a, b in p["index"])] = part
        out[key] = full
    return {k: v.to(_CANONICAL.get(v.dtype, v.dtype))
            for k, v in out.items()}


def load_arrays(prefix, epoch, validate=True, ctx=None):
    """A manifest checkpoint as a flat ``{'arg:name': NDArray}`` dict on
    ``ctx`` (the current context by default). ``validate`` checksums
    every artifact against the bytes it parses (one read a file), so a
    torn write raises."""
    from .context import current_context
    from .ndarray import NDArray
    device = (ctx or current_context()).torch_device()
    return {k: NDArray(v.to(device))
            for k, v in _read_host(prefix, epoch, validate).items()}


def load_param_arrays(prefix, epoch, validate=True):
    """``{name: CPU tensor}`` of a manifest checkpoint's entries under
    their plain names (``arg:``/``aux:`` dropped): the decode server's
    weight swap source (``DecodeServer.swap_weights(prefix=, epoch=)``).
    The caller places them; host tensors stand where the JAX package
    returns numpy arrays, since numpy has no bfloat16."""
    return {(k.split(":", 1)[1] if ":" in k else k): v
            for k, v in _read_host(prefix, epoch, validate).items()}
