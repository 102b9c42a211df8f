"""Carry a chain design across from its numpy state.

The JAX package's ``FusedChainCF`` holds its design as arrays
(``_h_filt``, ``_g_env``, ``env_delay``, ``spec_w``, ``filt_w``,
``env_w``) plus ``rate``, ``nfft``, ``hop`` and ``env_clamp``, and in its
"ifir" envelope mode the factored banks (:data:`IFIR_KEYS`).  Given those
as numpy values, :func:`chain_from_arrays` builds the port's module
with exactly the same coefficients, so both packages compute with one
design.  :func:`envdet_from_arrays` does the same for the song-detection
envelope from its symmetric kernels and geometry, and
:func:`sharded_pipeline_from_arrays` for the JAX ``ShardedPipeline``.
:func:`precision_from_jax` carries a JAX precision across.
"""

from __future__ import annotations

import numpy as np

from .graph.nodes import SpectrogramNode, device_params
from .ops.cuda import precision as _precision
from .ops.cuda.envdet import EnvDetKernel
from .ops.design import FilterDesign, FirKernels
from .ops.envdet import EnvDet
from .ops.fused import FusedChainCF
from .parallel import ShardedPipeline, make_mesh
from .utils import resolve_device

__all__ = ["ARRAY_KEYS", "DESIGN_KEYS", "ENVDET_KEYS", "IFIR_KEYS",
           "SHARDED_KEYS",
           "chain_from_arrays", "envdet_from_arrays",
           "node_params_from_arrays", "precision_from_jax",
           "sharded_pipeline_from_arrays"]

#: the state a chain is rebuilt from
ARRAY_KEYS = ("rate", "nfft", "hop", "env_clamp", "_h_filt", "_g_env",
              "env_delay", "spec_w", "filt_w", "env_w")

#: the state an "ifir" envelope adds (the JAX chain's attributes when its
#: ``env_mode`` is "ifir"; ``env_w`` is then ``None``)
IFIR_KEYS = ("env_mode", "ifir_M", "ifir_Lg", "env_halo", "env_i_w",
             "env_g_w")

#: the state a song-detection envelope is rebuilt from: the symmetric
#: band-pass and envelope kernels with their delays (the JAX package's
#: ``filtfilt_sym_kernel(design.sos, pad_to=design.fir.length)``), the
#: decimation step, outputs per window and the window headroom
ENVDET_KEYS = ("g_bp", "d_bp", "g_lp", "d_lp", "step", "nout", "hb")

#: the state a sharded pipeline is rebuilt from: the filter's truncated
#: impulse response (the JAX pipeline's ``filt.fir.h``, ``None`` without a
#: filter), the envelope's symmetric kernel and delay (its ``_env_sym``,
#: ``None`` without an envelope) and the geometry
SHARDED_KEYS = ("rate", "h_filt", "g_env", "env_delay", "env_clamp", "nfft",
                "hop", "spectrogram", "minmax_step")

#: the leaves of a filter or envelope node's design (the JAX package's
#: ``FilterDesign`` pytree: the SOS cascade, ``sosfilt_zi``, the
#: ``sosfiltfilt`` padding, and the truncated impulse, state-output and
#: input-state responses with the state matrix and truncation eps)
DESIGN_KEYS = ("sos", "zi0", "padlen", "h", "state_out", "input_state", "A",
               "eps")


def precision_from_jax(precision):
    """The port's rung (:mod:`audian_torch.ops.cuda.precision`) of a JAX
    precision: a ``lax.Precision`` (read by its ``.name``, so that nothing
    here imports jax), one of the JAX package's sentinel strings
    (``"bf16x3"``, ``"bf16x4"``), a rung already, or a 3-tuple of these
    (the chain's per-stage form); ``None`` stays ``None`` (the callee's
    default).  Anything else raises ValueError."""
    if precision is None:
        return None
    if isinstance(precision, (tuple, list)):
        if len(precision) != 3:
            raise ValueError(f"a per-stage precision has 3 entries, got "
                             f"{precision!r}")
        return tuple(precision_from_jax(p) for p in precision)
    name = getattr(precision, "name", precision)
    if not isinstance(name, str):
        raise ValueError(f"not a precision: {precision!r}")
    return _precision.check(name.lower())


def chain_from_arrays(arrays, device=None):
    """The port's :class:`FusedChainCF` over ``arrays`` (a dict holding
    :data:`ARRAY_KEYS`, and :data:`IFIR_KEYS` when its ``env_mode`` is
    "ifir"; a missing design is ``None``) on ``device`` (the CUDA card by
    default)."""
    ifir = arrays.get("env_mode") == "ifir"
    missing = set(ARRAY_KEYS + (IFIR_KEYS if ifir else ())) - set(arrays)
    if missing:
        raise KeyError(f"missing chain arrays: {sorted(missing)}")

    def arr(k, dtype):
        v = arrays.get(k)
        return None if v is None else np.asarray(v, dtype)

    g = arr("_g_env", np.float64)
    if ifir:
        env = {"env_mode": "ifir", "ifir_M": int(arrays["ifir_M"]),
               "ifir_Lg": int(arrays["ifir_Lg"]),
               "env_halo": int(arrays["env_halo"])}
    else:
        env = {"env_mode": None if g is None else "dense",
               "ifir_M": None, "ifir_Lg": None,
               "env_halo": 0 if g is None else len(g) - 1}
    return FusedChainCF.from_arrays({
        **env,
        "rate": float(arrays["rate"]),
        "nfft": int(arrays["nfft"]),
        "hop": int(arrays["hop"]),
        "env_clamp": bool(arrays["env_clamp"]),
        "_h_filt": arr("_h_filt", np.float64),
        "_g_env": g,
        "env_delay": int(arrays["env_delay"]),
        "spec_w": arr("spec_w", np.float32),
        "filt_w": arr("filt_w", np.float32),
        "env_w": arr("env_w", np.float32),
        "env_i_w": arr("env_i_w", np.float32),
        "env_g_w": arr("env_g_w", np.float32),
    }, device=device)


def envdet_from_arrays(arrays, kernel=True, device=None):
    """The port's single-pass :class:`EnvDetKernel` (``kernel=True``) or
    two-stage :class:`EnvDet` over ``arrays`` (a dict holding
    :data:`ENVDET_KEYS`) on ``device`` (the CUDA card by default)."""
    missing = set(ENVDET_KEYS) - set(arrays)
    if missing:
        raise KeyError(f"missing envdet arrays: {sorted(missing)}")
    cls = EnvDetKernel if kernel else EnvDet
    return cls.from_kernels(
        np.asarray(arrays["g_bp"], np.float64), int(arrays["d_bp"]),
        np.asarray(arrays["g_lp"], np.float64), int(arrays["d_lp"]),
        int(arrays["step"]), int(arrays["nout"]), int(arrays["hb"]),
        device=device)


def node_params_from_arrays(node, arrays, device=None):
    """The device parameters of the port's trace-graph ``node`` (what its
    ``compute`` takes) from the JAX node's ``params()`` as numpy values:
    for a :class:`~audian_torch.graph.nodes.SpectrogramNode` the STFT
    window (kept on the host, :meth:`~audian_torch.graph.nodes.Node.upload`),
    for a filter or envelope node a dict holding
    :data:`DESIGN_KEYS` (``None`` for a pass-through or infeasible
    design).  On ``device``, the CUDA card by default."""
    device = resolve_device(device)
    if isinstance(node, SpectrogramNode) or arrays is None:
        return node.upload(arrays, device)
    missing = set(DESIGN_KEYS) - set(arrays)
    if missing:
        raise KeyError(f"missing design arrays: {sorted(missing)}")

    def arr(k):
        return np.asarray(arrays[k], np.float64)

    fir = FirKernels(h=arr("h"), state_out=arr("state_out"),
                     input_state=arr("input_state"), eps=float(arrays["eps"]),
                     A=arr("A"))
    return device_params(FilterDesign(sos=arr("sos"), zi0=arr("zi0"),
                                      padlen=int(arrays["padlen"]), fir=fir),
                         device)


def sharded_pipeline_from_arrays(arrays, mesh, device=None):
    """The port's :class:`ShardedPipeline` over ``arrays`` (a dict holding
    :data:`SHARDED_KEYS`) on ``mesh``: a port
    :class:`~audian_torch.parallel.Mesh`, or a ``(seq, ch)`` shape for a
    mesh of ``seq * ch`` entries of ``device`` (the CUDA card by
    default)."""
    missing = set(SHARDED_KEYS) - set(arrays)
    if missing:
        raise KeyError(f"missing sharded pipeline arrays: {sorted(missing)}")
    if isinstance(mesh, tuple):
        seq, ch = mesh
        mesh = make_mesh([resolve_device(device)] * (seq * ch), seq=seq,
                         ch=ch)
    return ShardedPipeline.from_arrays(mesh, arrays)
