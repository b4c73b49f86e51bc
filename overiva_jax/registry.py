"""Algorithm registry: name -> runner, mirroring the reference's CLI names.

The reference exposes algorithm choice as strings (``example.py --algo``,
per-algo kwargs in ``mbss_sim_config.json`` — SURVEY.md §5.6). This registry
is the single dispatch point shared by the demo CLI, the sweep driver, and
user code:

    from overiva_jax.registry import get_algorithm, ALGORITHMS
    Y = get_algorithm("overiva-gauss")(X, n_src=2, n_iter=20)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from . import api

__all__ = ["AlgorithmSpec", "ALGORITHMS", "get_algorithm", "applicable"]


@dataclass(frozen=True)
class AlgorithmSpec:
    """One separation algorithm variant.

    determined: requires n_src == n_chan. single_output: always extracts one
    source. min_src: smallest supported n_src (IP2 needs pairs).
    defaults: reference-matching default kwargs. batch: same algorithm over
    a (B, T, F, M) stack in ONE fused XLA program (None where no batch path
    exists); per-element results match ``run`` on each X[b] — the sweep
    harness groups same-shape instances through it (SURVEY.md §3.4).
    """

    name: str
    run: Callable
    determined: bool = False
    single_output: bool = False
    min_src: int = 1
    defaults: dict = field(default_factory=dict)
    batch: Callable | None = None

    def __call__(self, X, n_src=None, **kw):
        params = {**self.defaults, **kw}
        if self.single_output:
            return self.run(X, **params)
        if self.determined:
            return self.run(X, n_src=n_src, **params)
        return self.run(X, n_src=n_src, **params)

    def run_batch(self, X_batch, n_src=None, **kw):
        """Batched dispatch with the same defaults; raises if no batch path."""
        if self.batch is None:
            raise ValueError(f"{self.name} has no batched implementation")
        params = {**self.defaults, **kw}
        if self.single_output:
            return self.batch(X_batch, **params)
        return self.batch(X_batch, n_src=n_src, **params)


def _gauss(fn):
    def run(X, **kw):
        kw.setdefault("model", "gauss")
        return fn(X, **kw)

    return run


def _df(fn):
    """Double-float certification tier (acc="f32x2", models/overiva_df.py):
    the f64-oracle-parity path on hardware with no native float64."""

    def run(X, **kw):
        kw.setdefault("model", "gauss")
        kw.setdefault("acc", "f32x2")
        return fn(X, **kw)

    return run


def _df_batch(fn):
    # the df tier is a certification tool, not a throughput path: the
    # batch contract is honored by a per-element loop (documented), so
    # certification arms can still ride the sweep harness
    import numpy as _np

    def run_batch(X_batch, **kw):
        kw.setdefault("model", "gauss")
        kw.setdefault("acc", "f32x2")
        kw.pop("device", None)  # harness-only kwarg of the fused batchers
        return _np.stack([fn(_np.asarray(Xb), **kw) for Xb in
                          _np.asarray(X_batch)])

    return run_batch


def _dfj(fn):
    """Joint-family df tier (acc="f32x2", models/joint_df.py): unlike the
    gauss-family `_df` names this does NOT force a model — tip's thin
    certification margin is a laplace-path effect."""

    def run(X, **kw):
        kw.setdefault("acc", "f32x2")
        return fn(X, **kw)

    return run


def _dfj_batch(fn):
    import numpy as _np

    def run_batch(X_batch, **kw):
        kw.setdefault("acc", "f32x2")
        kw.pop("device", None)
        return _np.stack([fn(_np.asarray(Xb), **kw) for Xb in
                          _np.asarray(X_batch)])

    return run_batch


ALGORITHMS: dict[str, AlgorithmSpec] = {
    s.name: s
    for s in [
        AlgorithmSpec("auxiva", api.auxiva, determined=True,
                      defaults={"n_iter": 20}, batch=api.overiva_batch),
        AlgorithmSpec("auxiva-gauss", _gauss(api.auxiva), determined=True,
                      defaults={"n_iter": 20},
                      batch=_gauss(api.overiva_batch)),
        AlgorithmSpec("auxiva-iss", api.auxiva_iss, determined=True,
                      defaults={"n_iter": 20}, batch=api.auxiva_iss_batch),
        AlgorithmSpec("auxiva-iss-gauss", _gauss(api.auxiva_iss), determined=True,
                      defaults={"n_iter": 20},
                      batch=_gauss(api.auxiva_iss_batch)),
        AlgorithmSpec("overiva", api.overiva, defaults={"n_iter": 20},
                      batch=api.overiva_batch),
        AlgorithmSpec("overiva-gauss", _gauss(api.overiva),
                      defaults={"n_iter": 20},
                      batch=_gauss(api.overiva_batch)),
        AlgorithmSpec("overiva-gauss-df", _df(api.overiva),
                      defaults={"n_iter": 20},
                      batch=_df_batch(api.overiva)),
        AlgorithmSpec("auxiva-gauss-df", _df(api.auxiva), determined=True,
                      defaults={"n_iter": 20},
                      batch=_df_batch(api.auxiva)),
        AlgorithmSpec("overiva-iss", api.overiva_iss,
                      defaults={"n_iter": 20}, batch=api.auxiva_iss_batch),
        AlgorithmSpec("overiva-iss-gauss", _gauss(api.overiva_iss),
                      defaults={"n_iter": 20},
                      batch=_gauss(api.auxiva_iss_batch)),
        AlgorithmSpec("tiss", api.tiss,
                      defaults={"n_iter": 20, "taps": 5, "delay": 2},
                      batch=api.tiss_batch),
        AlgorithmSpec("tiss-gauss", _gauss(api.tiss),
                      defaults={"n_iter": 20, "taps": 5, "delay": 2},
                      batch=_gauss(api.tiss_batch)),
        AlgorithmSpec("tip", api.tip,
                      defaults={"n_iter": 10, "warm_iter": 10,
                                "taps": 5, "delay": 2},
                      batch=api.tip_batch),
        AlgorithmSpec("tip-gauss", _gauss(api.tip),
                      defaults={"n_iter": 10, "warm_iter": 10,
                                "taps": 5, "delay": 2},
                      batch=_gauss(api.tip_batch)),
        AlgorithmSpec("tiss-df", _dfj(api.tiss),
                      defaults={"n_iter": 20, "taps": 5, "delay": 2},
                      batch=_dfj_batch(api.tiss)),
        AlgorithmSpec("tip-df", _dfj(api.tip),
                      defaults={"n_iter": 10, "warm_iter": 10,
                                "taps": 5, "delay": 2},
                      batch=_dfj_batch(api.tip)),
        AlgorithmSpec("overiva-ip2", api.overiva_ip2, min_src=2,
                      defaults={"n_iter": 10}, batch=api.overiva_ip2_batch),
        AlgorithmSpec("overiva-ip2-gauss", _gauss(api.overiva_ip2),
                      min_src=2, defaults={"n_iter": 10},
                      batch=_gauss(api.overiva_ip2_batch)),
        AlgorithmSpec("auxiva_pca", api.auxiva_pca, defaults={"n_iter": 20},
                      batch=api.auxiva_pca_batch),
        AlgorithmSpec("auxiva_pca-iss", api.auxiva_pca,
                      defaults={"n_iter": 20, "inner": "iss"},
                      batch=api.auxiva_pca_batch),
        AlgorithmSpec("auxiva_pca-ip2", api.auxiva_pca, min_src=2,
                      defaults={"n_iter": 10, "inner": "ip2"},
                      batch=api.auxiva_pca_batch),
        AlgorithmSpec("sparseauxiva", api.sparseauxiva, determined=True,
                      defaults={"n_iter": 20}, batch=api.sparseauxiva_batch),
        AlgorithmSpec("ilrma", api.ilrma, determined=True,
                      defaults={"n_iter": 30, "n_components": 2},
                      batch=api.ilrma_batch),
        AlgorithmSpec("ilrma-t", api.ilrma_t, determined=True,
                      defaults={"n_iter": 30, "n_components": 2,
                                "taps": 5, "delay": 2},
                      batch=api.ilrma_t_batch),
        AlgorithmSpec("fastmnmf", api.fastmnmf,
                      defaults={"n_iter": 30, "n_components": 2},
                      batch=api.fastmnmf_batch),
        AlgorithmSpec("fastmnmf2", api.fastmnmf2,
                      defaults={"n_iter": 30, "n_components": 2},
                      batch=api.fastmnmf2_batch),
        AlgorithmSpec("five", api.five, single_output=True,
                      defaults={"n_iter": 10}, batch=api.five_batch),
        AlgorithmSpec("ogive", api.ogive, single_output=True,
                      defaults={"n_iter": 4000, "step_size": 0.1,
                                "tol": 1e-3, "update": "demix"},
                      batch=api.ogive_batch),
        AlgorithmSpec("ogive-mix", api.ogive, single_output=True,
                      defaults={"n_iter": 4000, "step_size": 0.1,
                                "tol": 1e-3, "update": "mix"},
                      batch=api.ogive_batch),
        AlgorithmSpec("ogive-switching", api.ogive, single_output=True,
                      defaults={"n_iter": 4000, "step_size": 0.1,
                                "tol": 1e-3, "update": "switching"},
                      batch=api.ogive_batch),
    ]
}


def get_algorithm(name: str) -> AlgorithmSpec:
    try:
        return ALGORITHMS[name]
    except KeyError:
        raise ValueError(
            f"unknown algorithm {name!r}; available: {sorted(ALGORITHMS)}"
        ) from None


def applicable(name: str, n_src: int, n_chan: int) -> bool:
    """Whether this algorithm applies to an (n_src, n_chan) configuration."""
    spec = get_algorithm(name)
    if spec.single_output:
        return n_src == 1
    if spec.determined:
        return n_src == n_chan and n_src >= spec.min_src
    return spec.min_src <= n_src <= n_chan
