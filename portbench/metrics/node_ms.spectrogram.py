"""``node_ms.spectrogram``: the device ms of the graph's ``spectrogram`` node
(the PSD spectrogram) per step: the ``device_ms`` of the program's ``graph.node``
spans of that node in the window (CUDA events around its launches), over
the steps."""

NODE = "spectrogram"


def read(r, trace):
    from audian_torch.utils import trace as log

    ms = [e["device_ms"] for e in log.events("graph.node")
          if e.get("node") == NODE and "device_ms" in e]
    steps = len(r.calls.get("graph", ()))
    return sum(ms) / steps if ms and steps else None
