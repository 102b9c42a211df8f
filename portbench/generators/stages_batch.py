"""Generator ``stages_batch``: the batch chain over recording hours resident on
the card, for a design that ``chain_cf`` runs on its per-stage route (the
window products of :mod:`audian_torch.ops.cuda.window_matmul`).

``chain_batch``'s procedure with the chain's own halos (``FusedChainCF.hb``
and ``.ha``, whichever route it takes) in place of the single-pass
kernel's: the hour made from the seed in the halo-extended layout, whole
hours in the window, every chunk through ``chain_cf`` with its statistics,
dispatched ahead, each call's host time kept, the hour's statistics summed
on the card and pulled once it is enqueued.  The calls are recorded as
``chain_batch`` records them (``calls["chain"]``,
``host["enqueue.chain"]``), so that the batch cells' shared metrics read
them.  The chain is built and its halos read before the hour is made.
The control is the same chain at the traffic's ``control_precision``.

Checked: the filtered stream, the envelope, the PSD and the statistics of
chunks of the window's last hour (one drawn from the seed, and the ragged
last one) against the configuration's reference.
"""

from __future__ import annotations

import time

import torch

from .. import devtrace
from .chain_batch import _preset, checks, make_hour


def _chain(cfg, device, precision=None):
    """The program's chain for the configuration's preset, held to the
    configuration's numbers, or (``precision`` given) the same chain at
    that rung."""
    fc = _preset(cfg, device)
    if precision is None:
        return fc
    from audian_torch.models import get_preset

    return get_preset(cfg["preset"]).fused(
        float(cfg["rate_hz"]), eps=cfg["fir_truncation_eps"], device=device,
        precision=precision)


def run(r):
    cfg, tr, dev = r.config, r.traffic, r.device
    fc = _chain(cfg, dev, None if r.variant == "program"
                else tr["control_precision"])
    hb, ha = fc.hb, fc.ha
    chain = fc.chain_cf
    xs, sizes = make_hour(r, hb, ha)
    C = len(xs[0])
    nbins = int(cfg["nfft"]) // 2 + 1

    def hour(keep=(), kept=None, enqueue=None):
        acc = [torch.zeros(C, device=dev), torch.zeros(C, device=dev),
               torch.zeros((C, nbins), device=dev)]
        for k, (x, m) in enumerate(zip(xs, sizes)):
            a = time.perf_counter()
            out = chain(x, m, stats=True)
            if enqueue is not None:
                enqueue.append(time.perf_counter() - a)
            st = out[3]
            for s, key in zip(acc, ("power", "env_sum", "psd_sum")):
                s += st[key]
            if k in keep:
                kept[k] = out
        torch.stack([acc[0], acc[1], acc[2].sum(1)]).cpu()

    hour()                                    # warm-up: both shapes
    keep = (int(r.rng.integers(0, len(sizes) - 1)), len(sizes) - 1)
    kept, enqueue = {}, []
    r.reset_peak()
    r.setup_done()
    hours = 0
    with devtrace.window(r.trace) as traced:
        t0 = time.perf_counter()
        while True:
            hour(keep, kept, enqueue)
            hours += 1
            if time.perf_counter() - t0 >= r.seconds:
                break
        window_s = time.perf_counter() - t0
    r.read_peak()
    r.host["enqueue.chain"] = enqueue
    r.calls["chain"] = sizes * hours
    inputs = {k: xs[k] for k in keep}
    del xs, fc, chain
    r.free()
    ref = r.cell.reference()
    samples = []
    for k in keep:
        y, e, s, st = kept.pop(k)
        want = ref.chain(cfg, inputs[k], hb, sizes[k])
        samples.append(checks(y, e, s, st, want))
        del y, e, s, st, want
    rec_h = tr["recording_s"] / 3600.0
    return {"e2e": {"batch_s_per_rec_h": window_s / (hours * rec_h)},
            "samples": samples, "attempted": hours * len(sizes),
            "trace": traced.trace}
