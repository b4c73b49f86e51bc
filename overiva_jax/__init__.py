"""overiva_jax — blind source separation framework in JAX.

A from-scratch JAX/XLA framework with the capabilities of the
``onolab-tmu/overiva`` reference (WASPAA 2019 OverIVA companion code):
STFT-domain blind source separation with AuxIVA, OverIVA, OGIVE and
PCA+AuxIVA, plus the evaluation/simulation harness around them
(bss_eval metrics, shoebox image-source room simulation, Monte-Carlo
sweep) — and extensions: ISS/IP2 update rules, FIVE, ILRMA,
FastMNMF1/2, SparseAuxIVA, WPE dereverberation, the joint
dereverberation+separation family (tiss/tip/ilrma_t), and streaming
(OnlineAuxIVAISS/OnlineWPE/OnlineTISS). Every family has a NumPy
oracle twin, a batched runner, and a bin-sharded multi-chip path.

Public API mirrors the reference (SURVEY.md §2):

    overiva(X, n_src, n_iter, proj_back, W0, model, init_eig,
            return_filters, callback) -> Y
    auxiva(...), ogive(...), auxiva_pca(...)

accepting/returning NumPy complex STFT arrays shaped (n_frames, n_freq,
n_chan), while the hot loop runs as a single fused XLA program on the
accelerator.
"""

from .version import __version__

__all__ = ["__version__"]


def __getattr__(name):
    # Lazy imports keep `import overiva_jax` light and avoid importing JAX
    # for oracle-only / simulation-only use.
    if name in _API:
        module = __import__(f"overiva_jax.{_API[name]}", fromlist=[name])
        return getattr(module, name)
    raise AttributeError(f"module 'overiva_jax' has no attribute {name!r}")


_API = {
    "auxiva": "api",
    "auxiva_iss": "api",
    "overiva": "api",
    "overiva_ip2": "api",
    "auxiva_ip2": "api",
    "overiva_iss": "api",
    "overiva_batch": "api",
    "auxiva_iss_batch": "api",
    "overiva_ip2_batch": "api",
    "overiva_iss_batch": "api",
    "ogive_batch": "api",
    "five_batch": "api",
    "separate": "api",
    "ogive": "api",
    "five": "api",
    "auxiva_pca": "api",
    "pca": "api",
    "ilrma": "api",
    "fastmnmf": "api",
    "fastmnmf2": "api",
    "sparseauxiva": "api",
    "fastmnmf_batch": "api",
    "fastmnmf2_batch": "api",
    "sparseauxiva_batch": "api",
    "ilrma_batch": "api",
    "auxiva_pca_batch": "api",
    "wpe": "api",
    "wpe_batch": "api",
    "tiss": "api",
    "tiss_batch": "api",
    "ilrma_t": "api",
    "ilrma_t_batch": "api",
    "tip": "api",
    "tip_batch": "api",
    "Separator": "serving",
    "SERVABLE": "serving",
    "bucket_frames": "serving",
    "OnlineAuxIVAISS": "api",
    "OnlineTISS": "api",
    "OnlineWPE": "api",
    "stft_analysis": "api",
    "stft_analysis_batch": "api",
    "to_device": "api",
    "stft_synthesis": "api",
    "stft_synthesis_batch": "api",
    "projection_back": "api",
}
