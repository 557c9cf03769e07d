"""Hand-written CUDA kernels of the score network, with their plain versions.

- :func:`edge_embedder.edge_embedder` — embedder edge branch, once per
  forward (``csrc/edge_embedder_wg.cu`` in float32 without gradients,
  ``csrc/edge_embedder.cu`` otherwise: :func:`edge_embedder.forward_route`);
  its backward :func:`edge_embedder.edge_embedder_bwd`
  (``csrc/edge_embedder_bwd.cu``), once per train step.
- :func:`pair_mlp.pair_mlp` — edge-transition pair MLP, once per trunk
  block but the last (``csrc/pair_mlp_wg.cu`` in float32,
  ``csrc/pair_mlp_wg_bf16.cu`` in bf16: :func:`pair_mlp.forward_route`); its
  backward :func:`pair_mlp.pair_mlp_bwd` (``csrc/pair_mlp_bwd_wg.cu`` in
  float32, ``csrc/pair_mlp_bwd_wg_bf16.cu`` in bf16).
- :func:`ipa_attention.ipa_attention` — fused IPA attention
  (``csrc/ipa_attention.cu``), once per trunk block with
  ``model.ipa.use_pallas_ipa``.
"""
