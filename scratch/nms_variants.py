"""On-card A/B of the NMS keep-mask kernel against the one it replaced.

    python3 scratch/nms_variants.py

Needs one NVIDIA Hopper card and nvcc, and exits non-zero anywhere else.
It builds the shipped ``nms_sweep.cu`` (through ``_build``) and
``scratch/nms_sweep_sample_block.cu`` (the previous design: a bit mask over
every pair and one block a sample walking it box by box, with its own C
entry point, under
``mxnet_tpu_torch/_build/nms_variants/``) at once, then takes the
arguments of chip_smoke.py phase 30's calls of ``nms_keep`` at their
inputs: MultiBoxDetection's and box_nms's in the SSD300 head at B32 (8732
boxes, corner IoU, class-gated), MultiBoxDetection with force_suppress
(one chain of 8732 a sample) and the Proposal at B1 (6000 boxes, +1 IoU).
For each it holds both kernels' keep masks to ``nms_keep_plain`` over
every sample, then times them in the order old, new, new, old: device ms
of one call by CUDA-graph replay (the old kernel over a workspace it is
handed, as its wrapper did every call), and the new call's parts each
launched alone (chip_smoke.nms_passes_ms). Variants of the new source
(text edits of the shipped one, each of which must match once) are built
beside it and timed between the shipped kernel's two turns: a ring of 2
stages in the long sweep instead of 3, its columns copied 8 bytes a
cp.async instead of 16, a word's resolve that steps
through every candidate (not only those whose row clears something), and
a long sweep whose OR visits only the kept rows (a thread a quarter of a
64-row word of kept bits) instead of every row. ptxas's report of the builds, the card's name and power limit, and
one JSON line a shape are printed.
"""
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

OLD_SRC = os.path.join(ROOT, "scratch", "nms_sweep_sample_block.cu")
OUT = os.path.join(ROOT, "mxnet_tpu_torch", "_build", "nms_variants")
# variant of the shipped source -> [(shipped text, variant text)]
VARIANTS = {
    "stages-2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "copy-8-bytes": [("constexpr int kCopyWords = 2;",
                      "constexpr int kCopyWords = 1;")],
    # every candidate of a word takes a step of its resolve, empty row or not
    "no-empty-skip": [("const u64 empty = (u64)__ballot_sync(",
                       "const u64 empty = 0ull & (u64)__ballot_sync(")],
    # the long sweep's OR visits only the kept rows: a thread a quarter of a
    # 64-row word of kept bits (256 threads x 16 rows = a 4096-row stage)
    "quarter-or": [("""      for (int r = r0 + t; r < before; r += kThreads)
        if ((kept_bits[r >> 6] >> (r & 63)) & 1ull) acc |= buf[r - r0];""",
                    """      const int rq = r0 + 16 * t;
      if (rq < before) {
        unsigned bits =
            (unsigned)(kept_bits[rq >> 6] >> (rq & 63)) & 0xffffu;
        while (bits) {
          acc |= buf[rq - r0 + __ffs(bits) - 1];
          bits &= bits - 1u;
        }
      }""")],
}


def nvcc(src, lib):
    """Start nvcc on ``src`` into ``lib``; returns the process."""
    from mxnet_tpu_torch.parallel import _build
    os.makedirs(OUT, exist_ok=True)
    log = open(lib + ".log", "w")
    proc = subprocess.Popen([_build._nvcc()] + _build._FLAGS
                            + ["-o", lib, src], stdout=log,
                            stderr=subprocess.STDOUT)
    log.close()
    return proc


def build_variants():
    """Start nvcc on the old source and every variant; returns name ->
    (process, library path)."""
    from mxnet_tpu_torch.parallel import _build
    os.makedirs(OUT, exist_ok=True)
    jobs = {"old": (OLD_SRC, os.path.join(OUT, "libnms_sample_block.so"))}
    with open(os.path.join(_build._CSRC, "nms_sweep.cu")) as f:
        shipped = f.read()
    for name, edits in VARIANTS.items():
        text = shipped
        for a, b in edits:
            if text.count(a) != 1:
                chip_smoke.fail("variant %s: %r matches %d times"
                                % (name, a, text.count(a)))
            text = text.replace(a, b)
        src = os.path.join(OUT, "nms_%s.cu" % name)
        with open(src, "w") as f:
            f.write(text)
        jobs[name] = (src, os.path.join(OUT, "libnms_%s.so" % name))
    return {name: (nvcc(src, lib), lib) for name, (src, lib) in jobs.items()}


def old_entry(lib):
    fn = ctypes.CDLL(lib).mxt_nms_sweep
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p] * 4 + [i, i, f, i, p]
    fn.restype = ctypes.c_int
    return fn


def calls_at(mx, det, ctx):
    """name -> (boxes, thresh, cls, plus_one) of phase 30's calls."""
    out = {}
    anchors, cls_prob, loc, _ = chip_smoke.ssd_inputs(mx, ctx)
    with chip_smoke.nms_calls(det) as calls:
        dets = mx.nd.contrib.MultiBoxDetection(cls_prob, loc, anchors,
                                               **chip_smoke.SSD_DETECT)
        mx.nd.contrib.box_nms(dets, overlap_thresh=0.45, valid_thresh=0.01,
                              id_index=0)
        mx.nd.contrib.MultiBoxDetection(cls_prob, loc, anchors,
                                        force_suppress=True,
                                        **chip_smoke.SSD_DETECT)
    out["ssd MultiBoxDetection"], out["ssd box_nms"], \
        out["ssd force_suppress"] = calls
    _, nd_in = chip_smoke.rcnn_inputs(mx, ctx)
    with chip_smoke.nms_calls(det) as calls:
        mx.nd.contrib.Proposal(*[a[:1] for a in nd_in],
                               **chip_smoke.RCNN_RPN)
    out["rpn Proposal"] = calls[0]
    return out


def main():
    card = chip_smoke.phase_device()
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import detection as det
    from mxnet_tpu_torch.parallel import _build
    jobs = build_variants()
    _build.build_all(["nms_sweep"])
    libs = {}
    for name, (proc, lib) in jobs.items():
        if proc.wait() != 0:
            with open(lib + ".log") as f:
                chip_smoke.fail("nvcc failed on %s:\n%s" % (name, f.read()))
        libs[name] = lib
    for name, path in (("new", _build.log_path("nms_sweep")),
                       ("old", libs["old"] + ".log")):
        with open(path) as f:
            print("ptxas (%s):" % name)
            print("".join("  " + ln for ln in f if "Used" in ln
                          or "spill" in ln or "entry" in ln))
    old = old_entry(libs["old"])
    variants = {name: _build._declare(ctypes.CDLL(libs[name]), "nms_sweep")
                for name in VARIANTS}
    ctx = mx.gpu(0)
    for name, (boxes, thresh, cls, plus_one) in calls_at(mx, det,
                                                         ctx).items():
        B, n = boxes.shape[:2]
        nw = (n + 63) // 64
        mask = torch.empty((B, n, nw), dtype=torch.int64, device=boxes.device)
        keep_old = torch.empty((B, n), dtype=torch.bool, device=boxes.device)

        def run_old():
            rc = old(boxes.data_ptr(), None if cls is None else cls.data_ptr(),
                     mask.data_ptr(), keep_old.data_ptr(), B, n, float(thresh),
                     int(plus_one), torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                chip_smoke.fail("old launch failed: %d" % rc)

        def run_new():
            det.nms_keep(boxes, thresh, cls, plus_one)

        def run_variant(fn, work, keep):
            det._nms_launch(fn, boxes, thresh, cls, det._nms_order(cls),
                            plus_one, work, keep,
                            stream=torch.cuda.current_stream().cuda_stream)
        run_old()
        keep_new = det.nms_keep(boxes, thresh, cls, plus_one)
        keep_var = {}
        for vname, fn in variants.items():
            work = torch.empty(fn.workspace(B, n), dtype=torch.uint8,
                               device=boxes.device)
            keep_var[vname] = (fn, work, torch.empty_like(keep_new))
            run_variant(*keep_var[vname])
        torch.cuda.synchronize()
        for vname, (_, _, k) in keep_var.items():
            if not torch.equal(k, keep_new):
                chip_smoke.fail("%s: variant %s's keep mask differs"
                                % (name, vname))
        for lo in range(0, B, chip_smoke.NMS_CHUNK):
            sl = slice(lo, lo + chip_smoke.NMS_CHUNK)
            want = det.nms_keep_plain(boxes[sl], thresh,
                                      None if cls is None else cls[sl],
                                      plus_one)
            if not (torch.equal(keep_new[sl], want)
                    and torch.equal(keep_old[sl], want)):
                chip_smoke.fail("%s: a keep mask differs from nms_keep_plain "
                                "in samples %d-%d" % (name, lo, sl.stop - 1))
        times = {"old": [], "new": []}
        times.update((vname, []) for vname in variants)
        for which in ("old", "new") + tuple(variants) + ("new", "old"):
            fn = (run_old if which == "old" else run_new if which == "new"
                  else lambda v=which: run_variant(*keep_var[v]))
            times[which].append(chip_smoke.device_ms(fn, iters=3, reps=5))
        parts = chip_smoke.nms_passes_ms(det, boxes, thresh, cls, plus_one)
        bound, by = chip_smoke.nms_bound(keep_new, cls)
        chains = chip_smoke.nms_chains(cls, B, n)
        row = dict(call=name, B=B, n=n, plus_one=bool(plus_one),
                   gated=cls is not None, old_ms=times["old"],
                   new_ms=times["new"], new_parts_ms=parts,
                   variants_ms={v: times[v] for v in variants}, bound_ms=bound,
                   bound_by=by, chains=len(chains), longest=max(chains),
                   long_chains=sum(L > det.NMS_SHORT_CHAIN for L in chains),
                   kept=int(keep_new.sum()), card=card)
        print(json.dumps(row))
    print("card:", card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
