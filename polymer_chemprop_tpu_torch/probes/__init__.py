"""Kernel probes: where the band layer's time goes on the card, and whether
a split-bf16 tensor-core product beats FP32 at the layer's shape.

* :mod:`.band_layer_probe`: the layer (``full``), the band-layer control
  (``noq``, ``pure``), cuBLAS at the same shapes and calibration products;
* :mod:`.fused_matmul_probe`: the 3xBF16 tensor-core product against
  cuBLAS FP32 and TF32;
* :mod:`.determinism_probe`: each main path run twice on the card in
  torch's default mode, the first differing operator and every float sum
  that adds with atomics (also used by chip_smoke.py phase 14);
* :mod:`.timing`: the device clock both use (also used by chip_smoke.py);
* :mod:`.bench_batch`: the featurized bench batch both run on, and the
  synthetic copolymers.
"""
