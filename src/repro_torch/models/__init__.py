"""Model families of the port: the dense LM (``transformer``, ``attention``,
``layers``), xDeepFM and two-tower retrieval (``recsys``), and the weight
converter from the JAX package (``convert``)."""
