"""Hand-written CUDA kernels of the edge stack, with their plain versions.

- :func:`edge_embedder.edge_embedder` — embedder edge branch
  (``csrc/edge_embedder.cu``), once per forward.
- :func:`pair_mlp.pair_mlp` — edge-transition pair MLP
  (``csrc/pair_mlp.cu``), once per trunk block but the last.
"""
