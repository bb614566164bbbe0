"""Phases 30 and 33 of chip_smoke.py alone, with the nms_sweep rows."""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
import importlib  # noqa: E402

t0 = time.perf_counter()
card = cs.phase_device()
cs.phase_build()
tfa = importlib.import_module("mxnet_tpu_torch.parallel.flash_attention")
v = cs.phase_vision(card, tfa)
for key, rec in (("ssd", v["ssd"]), ("rpn", v["rpn"]),
                 ("force", v["ssd"]["force"])):
    print(json.dumps(cs.kernel_row("nms_sweep", cs.NMS_SRC, cs.NMS_TPU, key,
                                   "", {"nms_sweep": rec["launches"]}, rec,
                                   rec["err"])))
print("head_ms", v["ssd"]["head_ms"])
r = cs.phase_compile_cache(card)
print("total %.1f s" % (time.perf_counter() - t0))
