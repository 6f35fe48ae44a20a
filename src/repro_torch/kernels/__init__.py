"""Hand-written CUDA kernels for MoDeST's perf-critical layers.

The paper's compute hot spot is the aggregator: averaging ``sf·s`` incoming
models (a bandwidth-bound streaming reduction) every round. Model deltas
can be int8-quantised before they are pushed. Serving the dense LMs adds
attention.

* :mod:`repro_torch.kernels.fused` — whole-model one-pass aggregation over
  flat ``(P, N)`` buffers + fused aggregate→quantize, the seal of secure
  aggregation and the fused unmask→aggregate(→quantize) over sealed rows
  (``csrc/fused_agg.cu``)
* :mod:`repro_torch.kernels.aggregate` — per-leaf weighted multi-model
  average, fp32 or bf16 (``csrc/aggregate.cu``)
* :mod:`repro_torch.kernels.quantize` — per-tile int8 delta quantise and
  dequantise (``csrc/quantize.cu``)
* :mod:`repro_torch.kernels.flash_attention` — causal / full GQA
  attention by online softmax, forward (``csrc/flash_attention.cu``)
* :mod:`repro_torch.kernels.ops`   — model-level wrappers (public API)
* :mod:`repro_torch.kernels.ref`   — plain-torch oracles
* :mod:`repro_torch.kernels.build` — nvcc + ctypes build at first use

``KERNELS`` names every kernel of the package with its wrapper (whose
``launches`` attribute counts kernel launches), its source and the
reference kernel it replaces.
"""

from repro_torch.kernels.fused import (  # noqa: F401
    aggregate_flat_onepass,
    aggregate_quantize_flat,
    apply_mask_flat,
    unmask_aggregate_flat,
    unmask_aggregate_quantize_flat,
)
from repro_torch.kernels.ops import (  # noqa: F401
    aggregate_flat,
    aggregate_flatmodel,
    aggregate_pytree,
    dequantize_flat,
    masked_aggregate_flatmodel,
    quantize_flat,
    quantized_delta_pull,
    quantized_delta_push,
)
from repro_torch.kernels.aggregate import aggregate_tiles  # noqa: E402
from repro_torch.kernels.quantize import (  # noqa: E402
    dequantize_tiles,
    quantize_tiles,
)

# bound under another name, so that ``repro_torch.kernels.flash_attention``
# stays the module
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention as _flash_attention,
)

KERNELS = {
    "fused.agg": {
        "wrapper": aggregate_flat_onepass,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_agg.cu",
        "replaces": "src/repro/kernels/fused.py:98",
    },
    "fused.agg_quant": {
        "wrapper": aggregate_quantize_flat,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_agg.cu",
        "replaces": "src/repro/kernels/fused.py:117",
    },
    "fused.mask": {
        "wrapper": apply_mask_flat,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_agg.cu",
        "replaces": "src/repro/kernels/fused.py:311",
    },
    "fused.unmask_agg": {
        "wrapper": unmask_aggregate_flat,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_agg.cu",
        "replaces": "src/repro/kernels/fused.py:381",
    },
    "fused.unmask_agg_quant": {
        "wrapper": unmask_aggregate_quantize_flat,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_agg.cu",
        "replaces": "src/repro/kernels/fused.py:405",
    },
    "aggregate.agg": {
        "wrapper": aggregate_tiles,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/aggregate.cu",
        "replaces": "src/repro/kernels/aggregate.py:41",
    },
    "quantize.quant": {
        "wrapper": quantize_tiles,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:45",
    },
    "quantize.dequant": {
        "wrapper": dequantize_tiles,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:66",
    },
    "flash_attention": {
        "wrapper": _flash_attention,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:92",
    },
}
