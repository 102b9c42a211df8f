"""``stage_ms.filtered``: the mean device ms of the ``filtered`` stage of one
``chain_cf`` call on the per-stage route (the band-pass's window product):
the ``device_ms`` of the program's ``stages.stage`` spans with that stage
in the window (CUDA events around its launches)."""

STAGE = "filtered"


def read(r, trace):
    from audian_torch.utils import trace as log

    ms = [e["device_ms"] for e in log.events("stages.stage")
          if e.get("stage") == STAGE and "device_ms" in e]
    return sum(ms) / len(ms) if ms else None
