"""Sizes of the benchmark's CPU tests."""

#: A §6.1-shaped trace cut to CPU size (the full cells run on the card).
SMALL = {"trace": {"n_flows": 3000, "total_packets": 30000, "n_epochs": 8},
         "window": 4}
#: Counters past bfloat16's 256 exact integers, so the control shows.
HEAVY = {"trace": {"n_flows": 3000, "total_packets": 200000, "n_epochs": 4},
         "window": 2}
CELLS = ["cs-s61.ingest", "um-s61.entropy", "cs-s61.flowquery",
         "um-s61.ingest"]
