"""Independent NumPy reference implementations (the parity oracle).

Every algorithm in ``overiva_jax`` is tested against these implementations
(SDR/SIR within 0.1 dB per BASELINE.json). They follow the reference repo's
behavior as specified in SURVEY.md §2.3 and are deliberately written in plain
NumPy, independent of the JAX code paths.
"""

from .auxiva import auxiva
from .auxiva_iss import auxiva_iss
from .auxiva_pca import auxiva_pca, pca
from .fastmnmf2 import fastmnmf, fastmnmf2, fastmnmf2_loglik
from .sparseauxiva import sparseauxiva
from .five import five
from .models import EPS, MODELS, activations
from .ogive import ogive
from .online_iss import online_iss_run
from .overiva import overiva
from .overiva_ip2 import auxiva_ip2, overiva_ip2
from .overiva_iss import overiva_iss
from .projection import apply_projection_back, projection_back
from .stft import analysis, hann, stft_pad, synthesis, synthesis_window
from .tip import tip
from .tiss import tiss

__all__ = [
    "EPS",
    "MODELS",
    "activations",
    "analysis",
    "apply_projection_back",
    "auxiva",
    "auxiva_ip2",
    "auxiva_iss",
    "auxiva_pca",
    "fastmnmf",
    "fastmnmf2",
    "fastmnmf2_loglik",
    "sparseauxiva",
    "five",
    "hann",
    "ogive",
    "online_iss_run",
    "overiva",
    "overiva_ip2",
    "overiva_iss",
    "pca",
    "projection_back",
    "stft_pad",
    "synthesis",
    "synthesis_window",
    "tip",
    "tiss",
]
