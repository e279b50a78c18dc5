"""The port's tools: counterparts of the JAX repo's ``tools/`` scripts (run
with ``python -m``; they default to the card):

  profile_stem_pieces       the 224^2 stem's pieces, and the front GEMM with
                            statistics (``ops/stem_cuda.py::gemm_stats``)
  probe_conv                the 3x3 conv with a fused ReLU-affine
                            (``ops/conv3x3_cuda.py::conv3x3``) against cuDNN
  make_synthetic_guitarset  a GuitarSet-shaped tree of WAVs and JAMS from
                            the seed
  run_guitarset             the runbook: WAV + JAMS in, CQT features (on the
                            card), labels, training and the report out
"""
