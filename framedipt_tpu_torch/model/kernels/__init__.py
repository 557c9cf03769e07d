"""Hand-written CUDA kernels of the score network, with their plain versions.

- :func:`edge_embedder.edge_embedder` — embedder edge branch
  (``csrc/edge_embedder.cu``), once per forward; its backward
  :func:`edge_embedder.edge_embedder_bwd` (``csrc/edge_embedder_bwd.cu``),
  once per train step.
- :func:`pair_mlp.pair_mlp` — edge-transition pair MLP
  (``csrc/pair_mlp.cu``), once per trunk block but the last; its backward
  :func:`pair_mlp.pair_mlp_bwd` (``csrc/pair_mlp_bwd.cu``).
- :func:`ipa_attention.ipa_attention` — fused IPA attention
  (``csrc/ipa_attention.cu``), once per trunk block with
  ``model.ipa.use_pallas_ipa``.
"""
