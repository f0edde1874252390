"""hullwhite_tpu — Hull-White Monte Carlo pricing & sensitivities in JAX.

A from-scratch JAX/XLA framework with the capabilities of the CUDA
reference ``Monte-Carlo-simulation-of-Hull-White-model-and-sensitivities-
computation``: zero-coupon curve bootstrap, theta calibration recovery,
control-variate ZBC option pricing, and vega via pathwise tangents, AD, and
CRN finite differences — redesigned around matmuls (simulation as one
matmul), counter-based RNG, and psum-over-mesh scaling.
"""

from .config import HWConfig, ThetaSpec, tiny_config
from .models.hull_white import MarketCurve

__all__ = ["HWConfig", "ThetaSpec", "tiny_config", "MarketCurve"]
__version__ = "0.1.0"
