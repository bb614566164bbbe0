"""Phase 33 of chip_smoke.py alone, with its kernel row."""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

card = cs.phase_device()
r = cs.phase_compile_cache(card)
print(json.dumps(cs.kernel_row(
    "flash_decode", cs.DEC_SRC, cs.DEC_TPU, "compile cache, warm start",
    "B%d T%d H%d D%d" % cs.CC_DEC, r["launches"], r["rec"], r["err"])))
