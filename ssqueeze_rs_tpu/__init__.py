"""ssqueeze_rs_tpu — synchrosqueezing / time-frequency analysis in JAX.

A from-scratch JAX/XLA framework with the capability surface of
ssqueeze_rs / ssqueezepy (STFT, CWT, synchrosqueezed variants, wavelets,
ridge extraction): batched tensor programs instead of per-scale/per-frame
thread pools, and `jax.sharding` meshes with halo exchange for long
recordings.
"""
from .config import DEFAULTS, EPS32, EPS64, pi
from .utils.common import mad_rms, mad, est_riskshrink_thresh
from .wavelets import (Wavelet, center_frequency, freq_resolution,
                       time_resolution, adm_cwt, adm_ssq, morsefreq,
                       morsewave, morlet, bump, cmhat, hhhat, gmw,
                       gmw_l1, gmw_l2, gmw_l1_k, gmw_l2_k, compute_gmw)
from .scales import (cwt_scalebounds, make_scales, process_scales,
                     infer_scaletype, logscale_transition_idx)

__version__ = "0.1.0"

# transforms are imported lazily at the end so that low-level modules can be
# used without pulling jax transform code during docs/introspection
from .ops.stft import stft, istft, get_window  # noqa: E402
from .ops.cwt import cwt, icwt  # noqa: E402
from .ops.phase import phase_cwt, phase_stft, phase_cwt_num  # noqa: E402
from .ops.ssqueeze import ssqueeze  # noqa: E402
from .ops.ssq_cwt import ssq_cwt, issq_cwt  # noqa: E402
from .ops.ssq_stft import ssq_stft, issq_stft  # noqa: E402
from .ops.tkeo import tkeo, tkeo_modified  # noqa: E402
from .ridge import extract_ridges  # noqa: E402
from .signals import TestSignals  # noqa: E402
from .experimental import scale_to_freq, freq_to_scale  # noqa: E402
from . import toolkit  # noqa: E402
from . import visuals  # noqa: E402  (matplotlib imported lazily inside)
from .serve import TransformServer  # noqa: E402
from .streaming import (StreamingSTFT, StreamingSSQSTFT,  # noqa: E402
                        StreamingCWT, StreamingSSQCWT)
from .io import ParquetRecording, parquet_to_raw  # noqa: E402

# reference-name conveniences (ssqueezepy re-exports these at top level)
from .utils.pad import p2up, padsignal  # noqa: E402
from .utils.windows import window_norm, window_resolution  # noqa: E402
from .utils.common import (WARN, NOTE,  # noqa: E402
                           replace_at_inf_or_nan, replace_at_inf,
                           replace_at_nan, replace_at_value,
                           replace_under_abs)
from .ops.diff import trigdiff  # noqa: E402
from .ops.cwt import cwt_higher_order  # noqa: E402
from .wavelets.gmw import (morsewave, morseafun, laguerre,  # noqa: E402
                           gmw_k_constants)
from .wavelets.props import find_maximum, find_first_occurrence  # noqa: E402
from .utils.fft import xifn, afftshift_idx, aifftshift_idx  # noqa: E402


def wavs():
    """Names of supported wavelets (reference: ssqueezepy.wavs)."""
    from .wavelets.base import _FAMILIES
    return list(_FAMILIES)
from . import compat  # noqa: E402  (drop-in `_rs` API)
from . import algos  # noqa: E402  (reference kernel-layer API, jnp oracle)

__all__ = [
    "DEFAULTS", "EPS32", "EPS64", "pi", "mad_rms", "mad",
    "est_riskshrink_thresh", "Wavelet", "center_frequency",
    "freq_resolution", "time_resolution", "adm_cwt", "adm_ssq", "morsefreq",
    "morsewave", "cwt_scalebounds", "make_scales", "process_scales",
    "infer_scaletype", "logscale_transition_idx",
    "stft", "istft", "get_window", "cwt", "icwt", "phase_cwt", "phase_stft",
    "phase_cwt_num", "ssqueeze", "ssq_cwt", "issq_cwt", "ssq_stft",
    "issq_stft", "tkeo", "tkeo_modified", "extract_ridges", "TestSignals",
    "TransformServer", "StreamingSTFT", "StreamingSSQSTFT", "StreamingCWT",
    "StreamingSSQCWT",
]
