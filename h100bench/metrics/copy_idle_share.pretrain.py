"""copy_idle_share.pretrain: multimodal pretraining: the share of a step's
device idle that lies inside the program's span over the host batch's copy
to the card (``vt.batch_to_device``), the median step's (h100bench/spans.py), %."""

from h100bench.spans import idle_share


def read(rec):
    return idle_share(rec, "pretrain", ("vt.batch_to_device",))
