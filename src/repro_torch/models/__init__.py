"""Model families of the port: the dense and MoE LM (``transformer``,
``attention``, ``moe``, ``layers``), xDeepFM, SASRec, MIND and two-tower
retrieval (``recsys``), MeshGraphNet and its neighbor sampler (``gnn``),
and the weight converter from the JAX package (``convert``)."""
