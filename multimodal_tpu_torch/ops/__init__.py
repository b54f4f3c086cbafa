"""Operators of the port: each hand-written CUDA kernel beside its plain PyTorch version
(``block_attention``, ``fused_attention``, ``flash_attention``, ``block_mlp``, behind
``attention``), and the plain-torch numerics of the variational loss: ``sphere``
(``riemannian_grad``), ``bessel`` (``log_iv``, ``vmf_log_normalizer``) and ``draws`` (every
raw random draw of the samplers)."""
