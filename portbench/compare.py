"""The numbers the cells compare, each a gap between what the timed path
produced and the plain reference (float64), read on the device."""

from __future__ import annotations

import torch


def max_abs(got, want):
    """The largest absolute gap."""
    return float((got.double() - want.double()).abs().max())


def rel_scale(got, want):
    """The largest absolute gap over the reference's largest magnitude."""
    return max_abs(got, want) / float(want.double().abs().max())


def db_gap(got, want, within_db=60.0):
    """The largest |dB| gap of a power over the reference's bins within
    ``within_db`` of its peak."""
    got, want = got.double(), want.double()
    keep = want >= want.max() * 10.0 ** (-within_db / 10.0)
    return float((10.0 * torch.log10(got[keep].clamp_min(1e-300)
                                     / want[keep])).abs().max())


def rel_gap(got, want):
    """The largest gap relative to each reference value."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs()).max())


def differ_share(got, want):
    """The share of entries that are not equal."""
    return float((got != want).double().mean())
