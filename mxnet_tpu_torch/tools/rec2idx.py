"""Rebuild the .idx sidecar from a .rec file (counterpart of
``mxnet_tpu/tools/rec2idx.py``; parity: tools/rec2idx.py): scan the
RecordIO framing, record each record's byte offset, and write
tab-separated ``key\\toffset`` rows keyed by the record's IRHeader id
(or sequential position with --sequential-keys).
"""
from __future__ import annotations

import argparse

from .. import recordio


def build_index(rec_path, idx_path, sequential_keys=False):
    import os
    reader = recordio.MXRecordIO(rec_path, "r")
    n = 0
    # tmp + os.replace: a crash mid-index must not leave a
    # truncated .idx that silently drops records
    tmp = "%s.tmp.%d" % (idx_path, os.getpid())
    with open(tmp, "w") as fidx:
        while True:
            offset = reader.tell()
            payload = reader.read()
            if payload is None:
                break
            if sequential_keys:
                key = n
            else:
                header, _ = recordio.unpack(payload)
                key = int(header.id)
            fidx.write("%d\t%d\n" % (key, offset))
            n += 1
    os.replace(tmp, idx_path)
    reader.close()
    return n


def main(argv=None):
    p = argparse.ArgumentParser(
        description="create a RecordIO index file")
    p.add_argument("record", help="path to the .rec file")
    p.add_argument("index", help="path of the .idx file to write")
    p.add_argument("--sequential-keys", action="store_true",
                   help="key by position instead of header id")
    args = p.parse_args(argv)
    n = build_index(args.record, args.index, args.sequential_keys)
    print("wrote %d index entries to %s" % (n, args.index))
    return n


if __name__ == "__main__":
    main()
