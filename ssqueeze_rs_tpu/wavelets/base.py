"""Wavelet abstraction: pure frequency-domain functions of (omega; params).

Redesign of the reference's `Wavelet` class
(old/ssqueezepy/wavelets.py:43-470): instead of a stateful callable with GPU
flags, a wavelet here is a frozen, hashable spec whose `psih` evaluates with
either numpy (host planning: scale bounds, admissibility, properties) or
jax.numpy (traced transform code). Hashability lets every host-side planning
result be cached per (wavelet, N, ...) key.

Filterbank sampling is one batched expression `psih(scales[:, None] * xi)` —
the vmap/broadcast replacement for the reference's per-scale loops
(rust/src/spectral/cwt.rs:228-310).
"""
from __future__ import annotations

import itertools
from collections import OrderedDict
from dataclasses import dataclass
from functools import lru_cache, cached_property

import numpy as np

from ..config import DEFAULTS
from ..utils.common import assert_is_one_of
from ..utils.fft import xifn

# registry: name -> builder(params dict) -> psih function factory
_FAMILIES = {}


def register_family(name):
    def deco(builder):
        _FAMILIES[name] = builder
        return builder
    return deco


# Ad-hoc callable wavelets: bounded LRU of strong references. Strong
# refs keep `Wavelet.build(lambda ...)` working even when the caller
# drops their own reference (a weakref scheme broke exactly that), and
# the LRU bound keeps repeated throwaway lambdas from growing the
# registry without limit. Names are counter-unique forever, so a
# recycled id() can never alias a dead callable's jit/filterbank caches.
_CUSTOM_LRU: "OrderedDict[str, object]" = OrderedDict()
_CUSTOM_BY_ID: dict = {}
_CUSTOM_MAX = 64
_custom_counter = itertools.count()


def _register_callable(spec) -> str:
    name = _CUSTOM_BY_ID.get(id(spec))
    if (name is not None and name in _CUSTOM_LRU and
            _CUSTOM_LRU[name] is spec):
        _CUSTOM_LRU.move_to_end(name)
        return name
    name = f"_custom_{next(_custom_counter)}"
    _CUSTOM_LRU[name] = spec
    _CUSTOM_BY_ID[id(spec)] = name
    _FAMILIES[name] = lambda cfg, _fn=spec: (lambda w, xp: _fn(w))
    while len(_CUSTOM_LRU) > _CUSTOM_MAX:
        old, oldspec = _CUSTOM_LRU.popitem(last=False)
        _FAMILIES.pop(old, None)
        if _CUSTOM_BY_ID.get(id(oldspec)) == old:
            del _CUSTOM_BY_ID[id(oldspec)]
    return name


@dataclass(frozen=True)
class Wavelet:
    """Frozen wavelet spec. `psih(w, xp)` evaluates the frequency-domain
    wavelet; positive-frequency support assumed (analytic wavelets)."""
    name: str
    params: tuple  # sorted ((key, value), ...) pairs, hashable

    # -- construction ---------------------------------------------------------
    @staticmethod
    def build(spec="gmw", l1_norm: bool | None = None, **overrides) -> "Wavelet":
        """Accepts: Wavelet | str | (str, dict)  — reference API parity
        (old/ssqueezepy/_cwt.py:495-512 `_process_gmw_wavelet` included via
        `l1_norm`)."""
        if isinstance(spec, Wavelet):
            return spec
        if callable(spec) and not isinstance(spec, str):
            # custom psih callable (reference wavelets.py:43-84 accepts
            # fn(w)); registered under a stable per-function family name.
            # The callable must be xp-agnostic (take jnp arrays) to run
            # inside traced transforms.
            return Wavelet(_register_callable(spec), ())
        if isinstance(spec, tuple):
            name, opts = spec
            opts = dict(opts)
        else:
            name, opts = spec, {}
        name = name.lower()
        opts.update(overrides)
        assert_is_one_of(name, "wavelet", tuple(_FAMILIES))
        defaults = dict(DEFAULTS.get(name, {}))
        if name == "gmw" and l1_norm is not None:
            opts.setdefault("norm", "bandpass" if l1_norm else "energy")
        for k, v in defaults.items():
            opts.setdefault(k, v)
        return Wavelet(name, tuple(sorted(opts.items())))

    @property
    def config(self) -> dict:
        return dict(self.params)

    @property
    def config_str(self) -> str:
        """`config` formatted like the reference (wavelets.py:191-210):
        drops norm/centered_scale/dtype and a base wavelet's order=0,
        int-ifies whole floats."""
        cfg = ""
        for k, v in self.config.items():
            if k in ("norm", "centered_scale", "dtype"):
                continue
            if k == "order" and v == 0:
                continue
            if isinstance(v, float) and v.is_integer():
                v = int(v)
            cfg += f"{k}={v}, "
        return cfg.rstrip(", ") or "Default configs"

    # -- default-length state (reference wavelets.py:161-177) -----------------
    # `N`, `xi`, `wc` and the `Psih` cache are per-instance CONVENIENCE state,
    # deliberately excluded from the dataclass fields: two Wavelets with equal
    # (name, params) stay == and hash-equal regardless of their default N.
    @property
    def N(self) -> int:
        """Default length used when `N` is not passed to a method
        (reference: old/ssqueezepy/wavelets.py:161-171). Settable:
        `wavelet.N = 2048`."""
        return self.__dict__.get("_default_N", 1024)

    @property
    def xi(self):
        """Radian frequency grid at scale=1, length `self.N`
        (reference: old/ssqueezepy/wavelets.py:173-177)."""
        return xifn(1, self.N, xp=np)

    @property
    def dtype(self) -> str:
        """dtype at which psih/psi are generated. Host planning is float64;
        an explicit 'dtype' config overrides (reference wavelets.py:179-183)."""
        return str(self.config.get("dtype", "float64"))

    # -- evaluation -----------------------------------------------------------
    @cached_property
    def _fn(self):
        try:
            builder = _FAMILIES[self.name]
        except KeyError:
            raise RuntimeError(
                f"wavelet family '{self.name}' is no longer registered — "
                "custom callable wavelets are kept in a bounded LRU of "
                f"{_CUSTOM_MAX}; rebuild the Wavelet from its callable "
                "(Wavelet.build(fn)) to re-register") from None
        return builder(self.config)

    def psih(self, w, xp=np):
        """Evaluate the frequency-domain wavelet at radian frequencies `w`."""
        return self._fn(w, xp)

    def __call__(self, w):
        """numpy evaluation (host-side planning); mirrors reference
        `Wavelet.fn`."""
        return self.psih(np.asarray(w, dtype=np.float64), np)

    def psifn(self, w=None, *, scale=None, N=None):
        """Time-domain wavelet via spectral reversal + iFFT (reference
        signature/behavior parity: wavelets.py:97-109). With `w` given,
        inverts psih(w) directly; else samples at (scale, N) — defaults
        scale=1, N=self.N. Returns a complex numpy array."""
        if w is not None:
            psih = np.asarray(self(w), dtype=np.complex128).copy()
            # nohalf=False semantics: halve the Nyquist bin of even-length
            # grids for analyticity/decay (reference wavelets.py:86-95,
            # applied by psifn via self(w, nohalf=False))
            M = psih.shape[-1]
            if M % 2 == 0:
                psih[..., M // 2] /= 2
            pn = (-1.0) ** np.arange(M)
            return np.fft.ifft(psih * pn, axis=-1)
        scale = 1.0 if scale is None else scale
        N = self.N if N is None else int(N)
        out = np.asarray(self.psi_time(float(scale), N, xp=np))
        return out[0] if out.ndim == 2 else out

    def xifn(self, scale=None, N=None):
        """Radian frequencies `scale * xi(1, N)` (reference name/behavior
        parity: old/ssqueezepy/wavelets.py:111-133). 1D array `scale`
        broadcasts to a (n_scales, N) grid; defaults scale=1, N=self.N."""
        if N is None and scale is None:
            return self.xi
        N = self.N if N is None else int(N)
        scale = 1.0 if scale is None else scale
        scale = np.asarray(scale, dtype=np.float64)
        if scale.ndim > 1 and scale.squeeze().ndim > 1:
            raise ValueError("2D `scale` unsupported")
        if scale.ndim >= 1 and scale.size > 1:
            scale = scale.reshape(-1, 1)
        return scale * xifn(1, N, xp=np)

    def Psih(self, scale=None, N=None, nohalf=True):
        """Filterbank memo: recompute only when (scale, N) changed since the
        last call; both None returns the previous result (reference:
        old/ssqueezepy/wavelets.py:135-160). Cached outside the dataclass
        fields, so ==/hash are unaffected."""
        d = self.__dict__
        pN, ps = d.get("_Psih_N"), d.get("_Psih_scale")
        N_is_None = N is None
        N = N or self.N
        if "_Psih" in d:
            if scale is None and N_is_None:
                return d["_Psih"]
            if (N == pN and scale is not None and ps is not None and
                    np.shape(scale) == np.shape(ps) and
                    np.allclose(np.asarray(scale, dtype=np.float64), ps)):
                return d["_Psih"]
        if scale is None:
            scale = 1.0   # reference __call__(scale=None) evaluates at 1
        out = self.sample(np.asarray(scale, dtype=np.float64), int(N),
                          xp=np, nohalf=nohalf)
        d["_Psih"] = out
        d["_Psih_N"] = int(N)
        d["_Psih_scale"] = np.asarray(scale, dtype=np.float64)
        return out

    def sample(self, scales, N: int, xp=np, nohalf: bool = False):
        """Filterbank `psih(scales[:, None] * xi(1, N))`, one batched eval.

        `nohalf=False` halves the Nyquist bin (even N) for analyticity
        (reference: old/ssqueezepy/wavelets.py:86-95).
        Returns shape (len(scales), N), or (N,) for scalar scale.
        """
        xi = xifn(1, N, xp=xp)
        scales = xp.asarray(scales)
        scalar = (getattr(scales, "ndim", 0) == 0)
        w = (scales * xi) if scalar else (scales.reshape(-1, 1) * xi[None, :])
        psih = self.psih(w, xp)
        if not nohalf and N % 2 == 0:
            if xp is np:
                psih = psih.copy()
                psih[..., N // 2] = psih[..., N // 2] / 2
            else:
                psih = psih.at[..., N // 2].divide(2)
        return psih

    def psi_time(self, scale, N: int, xp=np):
        """Centered time-domain wavelet via spectral reversal + iFFT
        (reference: old/ssqueezepy/wavelets.py:97-109)."""
        psih = self.sample(scale, N, xp=xp, nohalf=False)
        pn = (-1.0) ** xp.arange(N)
        return xp.fft.ifft(psih * pn, axis=-1)

    # -- properties (host-side, cached) ----------------------------------------
    @cached_property
    def wc_ct(self) -> float:
        """Continuous-time radian peak frequency (kind='peak-ct')."""
        from .props import find_maximum
        w_peak, _ = find_maximum(self)
        return float(w_peak)

    @cached_property
    def scalec_ct(self) -> float:
        """Scale putting the peak at pi/4 (reference wavelets.py:239-246)."""
        return (4 / np.pi) * self.wc_ct

    @property
    def wc(self) -> float:
        """Energy center frequency at scale=scalec_ct, N=self.N
        [(radians*cycles)/samples] (reference: wavelets.py:211-226). Cached;
        `reset_properties()` recomputes for the current `self.N`."""
        if self.__dict__.get("_wc") is None:
            self.__dict__["_wc"] = float(self.center_frequency(
                scale=self.scalec_ct, N=self.N, kind="energy"))
        return self.__dict__["_wc"]

    TF_PROPS = ("wc", "wc_ct", "scalec_ct")

    def reset_properties(self):
        """Recompute cached time-frequency properties for the current
        `self.N` (reference: wavelets.py:334-340). Covers `TF_PROPS`; the
        std_t/std_w family is computed on demand here, so it never stales."""
        for name in ("_wc", "wc_ct", "scalec_ct", "_Psih", "_Psih_N",
                     "_Psih_scale"):
            self.__dict__.pop(name, None)
        _ = (self.wc_ct, self.scalec_ct, self.wc)

    def center_frequency(self, scale=None, N=1024, kind="energy",
                         force_int=None):
        from .props import center_frequency
        return center_frequency(self, scale=scale, N=N, kind=kind,
                                force_int=force_int)

    def std_t(self, scale=None, N=1024, nondim=True):
        from .props import time_resolution
        scale = self.scalec_ct if scale is None else scale
        return time_resolution(self, scale=scale, N=N, nondim=nondim)

    def std_w(self, scale=None, N=1024, nondim=True):
        from .props import freq_resolution
        scale = self.scalec_ct if scale is None else scale
        return freq_resolution(self, scale=scale, N=N, nondim=nondim)

    def harea(self, scale=None, N=1024):
        return self.std_t(scale, N) * self.std_w(scale, N)

    # reference-name resolution variants (wavelets.py:259-293):
    # std_f = cyclic frequency resolution; *_d = dimensional (samples)
    def std_f(self, scale=None, N=1024, nondim=True):
        return self.std_w(scale, N, nondim=nondim) / (2 * np.pi)

    def std_t_d(self, scale=None, N=1024):
        return self.std_t(scale, N, nondim=False)

    def std_w_d(self, scale=None, N=1024):
        return self.std_w(scale, N, nondim=False)

    def std_f_d(self, scale=None, N=1024):
        return self.std_w_d(scale, N) / (2 * np.pi)

    VISUALS = ("heatmap", "waveforms", "filterbank", "harea", "std_t",
               "std_w", "time-frequency", "anim:time-frequency")

    def viz(self, name="overview", **kw):
        """Wavelet visuals dispatch (reference: wavelets.py:342-366).
        `Wavelet.VISUALS` lists supported names; 'overview' plots the
        heatmap, harea sweep, filterbank and time-frequency views."""
        from .. import visuals
        if name == "overview":
            for nm in ("heatmap", "harea", "filterbank", "time-frequency"):
                self.viz(nm, **kw)
            return
        if name not in Wavelet.VISUALS:
            raise ValueError(f"visual '{name}' not supported; must be one "
                             "of: " + ", ".join(Wavelet.VISUALS))
        fn = {
            "heatmap": visuals.wavelet_heatmap,
            "waveforms": visuals.wavelet_waveforms,
            "filterbank": visuals.wavelet_filterbank,
            "harea": visuals.sweep_harea,
            "std_t": visuals.sweep_std_t,
            "std_w": visuals.sweep_std_w,
            "time-frequency": visuals.wavelet_tf,
            "anim:time-frequency": visuals.wavelet_tf_anim,
        }[name]
        fn(self, **kw)

    def info(self, nondim=True, N=1024):
        """Print time & frequency resolution summary
        (reference parity: wavelets.py:297-332)."""
        if nondim:
            std_t, std_w = self.std_t(N=N), self.std_w(N=N)
            wc, wc_txt = self.wc_ct, "wc_ct, (cycles*radians)"
            dim_t = dim_w = "non-dimensional"
        else:
            std_t = self.std_t(N=N, nondim=False)
            std_w = self.std_w(N=N, nondim=False)
            from .props import center_frequency
            wc = center_frequency(self, scale=self.scalec_ct, N=N,
                                  kind="energy")
            wc_txt = f"wc, (cycles*radians)/samples; scale={self.scalec_ct:.2f}"
            dim_t = "samples/(cycles*radians)"
            dim_w = "(cycles*radians)/samples"
        cfg = self.config_str
        print(f"{self.name} wavelet\n\t{cfg}\n"
              f"\tCenter frequency: {wc:<10.6f} [{wc_txt}]\n"
              f"\tTime resolution:  {std_t:<10.6f} [std_t, {dim_t}]\n"
              f"\tFreq resolution:  {std_w:<10.6f} [std_w, {dim_w}]\n"
              f"\tHeisenberg area:  {std_t * std_w:.12f}")


# `wavelet.N = value` parity (reference wavelets.py:166-171): the frozen
# dataclass's generated __setattr__ rejects every assignment (and dataclass
# forbids defining __setattr__ in the class body when frozen=True), so route
# just the documented mutable convenience state around it post-class. The
# value lands in instance __dict__, not a field — ==/hash stay (name, params).
_frozen_setattr = Wavelet.__setattr__


def _wavelet_setattr(self, name, value):
    if name == "N":
        self.__dict__["_default_N"] = int(value)
        self.__dict__.pop("_wc", None)  # wc is tied to N (reference ties
        return                          # xi to N the same way)
    _frozen_setattr(self, name, value)


Wavelet.__setattr__ = _wavelet_setattr


def isinstance_by_name(obj, ref):
    """Class-identity check robust to module reloads (reference parity:
    old/ssqueezepy/wavelets.py:977-983): compares fully-qualified class
    names instead of class objects."""
    def _class_name(o):
        name = getattr(o, "__qualname__", getattr(o, "__name__", ""))
        return (getattr(o, "__module__", "") + "." + name).lstrip(".")
    return _class_name(type(obj)) == _class_name(ref)


@lru_cache(maxsize=256)
def _cached_wavelet(name, params):
    return Wavelet(name, params)
