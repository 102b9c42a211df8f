"""Generator ``chain_batch``: the batch chain over recording hours resident on
the card.

The hour is made from the seed in the halo-extended layout that
``FusedChainCF.chain_cf`` takes: chunks of ``chunk_frames`` frames (the
last one the hour's remainder), each with the recording's own samples in
its halos.  The window runs whole hours, every chunk through ``chain_cf``
with its statistics, dispatched ahead; the hour's statistics, summed on the
card, are pulled once it is enqueued, the only synchronize.  Set-up warms
both chunk shapes with one hour.

Checked: the filtered stream, the envelope, the PSD and the statistics of
chunks of the window's last hour (one drawn from the seed, and the ragged
last one) against the configuration's reference.
"""

from __future__ import annotations

import time

import torch

from .. import compare, devtrace, recordings


def _preset(cfg, device):
    """The program's chain for the configuration's preset, held to the
    configuration's numbers."""
    from audian_torch.models import get_preset

    p = get_preset(cfg["preset"])
    got = (p.highpass_cutoff, p.lowpass_cutoff, p.filter_order,
           p.envelope_cutoff, p.nfft,
           int(round((1 - p.overlap_frac) * p.nfft)))
    want = (cfg["highpass_hz"], cfg["lowpass_hz"], cfg["filter_order"],
            cfg["envelope_hz"], cfg["nfft"], cfg["hop"])
    if got != want:
        raise ValueError(f"preset {cfg['preset']!r} is {got}, the "
                         f"configuration {want}")
    return p.fused(float(cfg["rate_hz"]), eps=cfg["fir_truncation_eps"],
                   device=device)


def _control(fc, precision, device):
    """The program's own lower rung in its place: the chain kernel of the
    same design at ``precision``."""
    from audian_torch.ops.cuda.chain import ChainKernel

    return ChainKernel(fc.rate, fc._h_filt, fc._g_env, fc.env_delay,
                       fc.spec_w.cpu().numpy(), fc.nbins,
                       env_clamp=fc.env_clamp, nfft=fc.nfft, device=device,
                       precision=precision)


def make_hour(r, hb, ha):
    """The hour's chunks ``(C, hb + m + ha)`` int16 and their sizes
    ``m``."""
    cfg, tr, dev = r.config, r.traffic, r.device
    rate, C = float(cfg["rate_hz"]), int(cfg["channels"])
    n = int(tr["chunk_frames"])
    total = int(round(tr["recording_s"] * rate))
    sizes = [min(n, total - k) for k in range(0, total, n)]
    gen = recordings.generator(r.seed, dev)
    xs = [torch.empty((C, hb + m + ha), dtype=torch.int16, device=dev)
          for m in sizes]
    start = 0
    for x, m in zip(xs, sizes):
        x[:, hb : hb + m].copy_(recordings.gated_tone(
            gen, start, m, C, rate, tr["signal"], dev).T)
        start += m
    for k, (x, m) in enumerate(zip(xs, sizes)):
        if k:
            p = sizes[k - 1]
            x[:, :hb].copy_(xs[k - 1][:, p : hb + p])
        else:
            x[:, :hb] = 0
        if k + 1 < len(xs):
            x[:, hb + m :].copy_(xs[k + 1][:, hb : hb + ha])
        else:
            x[:, hb + m :] = 0
    return xs, sizes


def run(r):
    cfg, tr, dev = r.config, r.traffic, r.device
    fc = _preset(cfg, dev)
    ck = fc.chain_kernel
    chain = (fc.chain_cf if r.variant == "program"
             else _control(fc, tr["control_precision"], dev))
    xs, sizes = make_hour(r, ck.hb, ck.ha)
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
    hb = ck.hb
    inputs = {k: xs[k] for k in keep}
    del xs, fc, ck, chain
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


def checks(y, e, s, st, want):
    """The gaps of one chunk: filtered and envelope (absolute, unit-scale
    PCM), the PSD (dB, bins within 60 dB of the chunk's peak), and the
    statistics (relative; the PSD sums over bins within 60 dB)."""
    keep = want["psd_sum"] >= want["psd_sum"].max() * 1e-6
    return {
        "filtered_err": compare.max_abs(y, want["filtered"]),
        "envelope_err": compare.max_abs(e, want["envelope"]),
        "psd_db_err": compare.db_gap(s, want["psd"]),
        "stats_rel_err": max(
            compare.rel_gap(st["power"], want["power"]),
            compare.rel_gap(st["env_sum"], want["env_sum"]),
            compare.rel_gap(st["psd_sum"][keep], want["psd_sum"][keep])),
    }
