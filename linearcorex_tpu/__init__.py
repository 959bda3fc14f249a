"""linearcorex_tpu — a JAX rebuild of Linear CorEx.

Re-implements the full capability surface of gregversteeg/LinearCorex
(latent factor models maximizing total correlation explained; see SURVEY.md)
as an idiomatic JAX/XLA library: the annealed fixed-point fit compiles to a
single device program, the moments are a few large GEMMs,
restarts/model-selection vmap, and large problems shard over device meshes.

Usage (reference-compatible, `import linearcorex_tpu as lc`):

    c = lc.Corex(n_hidden=8).fit(x)
    y = c.transform(x)
    c.tc, c.tcs, c.mis, c.clusters
"""

from linearcorex_tpu.config import CorexConfig, PreprocessConfig
from linearcorex_tpu.models.corex import Corex, NotFittedError
from linearcorex_tpu.models.selection import (pick_n_hidden,
                                               warmup_sweep)
from linearcorex_tpu.models.stacked import StackedCorex
from linearcorex_tpu.ops.moments import (QuantizedData, quantize_gram,
                                         quantize_samples)
from linearcorex_tpu.utils.checkpoint import load_corex, save_corex
from linearcorex_tpu.utils.compile_cache import (ensure_compile_cache,
                                                 warmup_fit,
                                                 warmup_serving)
from linearcorex_tpu.utils.streaming import (GramAccumulator,
                                             fit_csv,
                                             fit_from_covariance)

__version__ = "0.4.0"
__all__ = [
    "Corex",
    "NotFittedError",
    "CorexConfig",
    "PreprocessConfig",
    "StackedCorex",
    "pick_n_hidden",
    "warmup_sweep",
    "save_corex",
    "load_corex",
    "GramAccumulator",
    "fit_csv",
    "fit_from_covariance",
    "QuantizedData",
    "quantize_samples",
    "quantize_gram",
    "ensure_compile_cache",
    "warmup_fit",
    "warmup_serving",
    "__version__",
]
