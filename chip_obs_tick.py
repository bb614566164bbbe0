"""Scheduler-tick wall time of the decode server on one card: an earlier
commit beside the checkout, and the checkout disarmed, armed, and armed
with a /metrics scrape thread.

    python3 chip_obs_tick.py [--parent DIR] [--rounds N] [--ticks N]

Each run is a process of its own that imports ``mxnet_tpu_torch`` from
one tree (the checkout, or DIR: an earlier commit unpacked with ``git
archive`` in a directory that .gitignore lists), builds its kernels,
serves the GPT-2-small-width ``ToyDecoderLM`` (random weights, seed 0)
from ``chip_smoke.tick_server`` (phase 9's server: ladder [256], window
8) and times ``chip_smoke.tick_turn`` turns: 8 fresh requests with
prompts of 256, then ``--ticks`` scheduler ticks around the replayed
step, one by one. An earlier tree runs its disarmed turns only (its
observability hooks may be stubs); the checkout runs each mode in every
round, the order reversed each round. With ``--parent`` the runs go
parent, checkout, checkout, parent. Each run prints one JSON line; the
last line sums up each tree and mode as the medians of its turns, and
the scrape thread's ms a scrape (request to page read), median and
max.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT_MODES = ("disarmed", "armed", "armed+scrape")


def child(tree, modes, rounds, ticks):
    sys.path.insert(0, HERE)              # chip_smoke of the checkout
    sys.path.insert(0, tree)              # ... over the tree's package
    import numpy as np

    import chip_smoke as c
    import mxnet_tpu_torch
    from mxnet_tpu_torch.parallel import _build
    from mxnet_tpu_torch.serving import ToyDecoderLM
    pkg = os.path.dirname(os.path.abspath(mxnet_tpu_torch.__file__))
    if pkg != os.path.join(os.path.abspath(tree), "mxnet_tpu_torch"):
        c.fail("imported %s, not the tree's package" % pkg)
    card = c.phase_device()
    _build.build_all()
    model = ToyDecoderLM(**c.GPT2_SMALL)
    params = model.init_params(seed=0, device="cuda")
    srv = c.tick_server(model, params, ticks)
    rs = np.random.RandomState(12)
    turns = {mode: [] for mode in modes}
    try:
        for r in range(rounds):
            for mode in (modes if r % 2 == 0 else modes[::-1]):
                turns[mode].append(
                    c.tick_turn(srv, model.vocab, rs, ticks, mode))
    finally:
        srv.stop(drain=False)
    print(json.dumps({"tree": tree, "card": card, "ticks": ticks,
                      "turns": turns}))


def run(tree, modes, rounds, ticks):
    out = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", tree,
         "--modes", ",".join(modes), "--rounds", str(rounds), "--ticks",
         str(ticks)], capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        print(out.stdout[-3000:], out.stderr[-3000:])
        sys.exit("run of %s failed" % tree)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(rec))
    return rec


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--parent", default=None)
    p.add_argument("--child", default=None)
    p.add_argument("--modes", default=",".join(CHECKOUT_MODES))
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--ticks", type=int, default=100)
    args = p.parse_args()
    if args.child:
        child(args.child, tuple(args.modes.split(",")), args.rounds,
              args.ticks)
        return
    runs = [(HERE, CHECKOUT_MODES)]
    if args.parent:
        parent = (os.path.abspath(args.parent), ("disarmed",))
        runs = [parent, runs[0], runs[0], parent]
    recs = [run(tree, modes, args.rounds, args.ticks)
            for tree, modes in runs]
    summary = {}
    for rec in recs:
        name = "checkout" if rec["tree"] == HERE else "parent"
        for mode, turns in rec["turns"].items():
            s = summary.setdefault("%s %s" % (name, mode), [])
            s.extend(turns)
    medians = {}
    for key, v in summary.items():
        medians[key] = {
            "tick_mean_ms": statistics.median(t[0] for t in v),
            "tick_median_ms": statistics.median(t[1] for t in v),
            "inter_token_p50_ms": statistics.median(t[2] for t in v),
            "turns": len(v)}
        scrapes = [ms for t in v for ms in t[3]]
        if scrapes:
            medians[key].update(scrapes=len(scrapes),
                                scrape_ms_median=statistics.median(scrapes),
                                scrape_ms_max=max(scrapes))
    print(json.dumps({"card": recs[0]["card"], "ticks": args.ticks,
                      "medians": medians}))


if __name__ == "__main__":
    main()
