"""Flakiness checker (counterpart of
``mxnet_tpu/tools/flakiness_checker.py``; parity:
tools/flakiness_checker.py): run one
test many times with different seeds to estimate flakiness.

Run: ``python -m mxnet_tpu_torch.tools.flakiness_checker
tests/test_torch_tools.py -n 20``.
"""
from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys

DEFAULT_NUM_TRIALS = 10


def run_test_trials(test_path, num_trials, seed=None, verbose=False):
    """Run the test ``num_trials`` times under fresh MXNET_TEST_SEEDs;
    returns (failures, seeds_used)."""
    failures = []
    seeds = []
    base = random.Random(seed)
    for trial in range(num_trials):
        s = base.randint(0, 2 ** 31 - 1)
        seeds.append(s)
        # MXNET_TEST_SEED is WRITTEN for the child process here, not
        # read — the typed read side lives in tests/conftest.py
        env = dict(os.environ, MXNET_TEST_SEED=str(s))
        out = subprocess.run(
            [sys.executable, "-m", "pytest", test_path, "-x", "-q"],
            capture_output=True, text=True, env=env)
        status = "PASS" if out.returncode == 0 else "FAIL"
        if verbose or status == "FAIL":
            print("trial %d seed %d: %s" % (trial, s, status),
                  flush=True)
        if out.returncode != 0:
            failures.append((s, out.stdout[-2000:]))
    return failures, seeds


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Check a test for flakiness")
    p.add_argument("test", help="pytest node id, e.g. "
                                "tests/test_ndarray.py::test_basic")
    p.add_argument("-n", "--num-trials", type=int,
                   default=DEFAULT_NUM_TRIALS)
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)
    failures, seeds = run_test_trials(args.test, args.num_trials,
                                      args.seed, args.verbose)
    print("%d/%d trials failed" % (len(failures), args.num_trials))
    for s, tail in failures:
        print("--- seed %d ---" % s)
        print(tail)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
