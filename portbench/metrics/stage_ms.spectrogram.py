"""``stage_ms.spectrogram``: the mean device ms of the ``spectrogram`` stage
of one ``chain_cf`` call on the per-stage route (the PSD's window product
and its power): the ``device_ms`` of the program's ``stages.stage`` spans
with that stage in the window (CUDA events around its launches)."""

STAGE = "spectrogram"


def read(r, trace):
    from audian_torch.utils import trace as log

    ms = [e["device_ms"] for e in log.events("stages.stage")
          if e.get("stage") == STAGE and "device_ms" in e]
    return sum(ms) / len(ms) if ms else None
