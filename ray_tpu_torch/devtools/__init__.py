"""Developer tooling for the ray_tpu_torch runtime.

``python -m ray_tpu_torch.devtools.lint`` — ``raylint``, the runtime-invariant
static analyzer (rules RTL001–RTL006, see ``docs/static_analysis.md``).
Its dynamic companion, the ``RAY_TPU_TORCH_DEBUG_LOCKS=1`` lock-order cycle
detector, lives in ``ray_tpu_torch.util.debug_locks``.
"""
