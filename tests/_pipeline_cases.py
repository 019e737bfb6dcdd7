"""The pipeline tests' cases and sizes, shared by the JAX reference script
(``tests/_jax_pipeline_ref.py``) and the port's worlds
(``tests/_torch_world.py``); imports neither package."""

# (name, pods, stage grid (data, mx, my), strategy, overlap, residual, microbatches)
CASES = (("steps", 2, (1, 1, 1), "hecaton", "none", "seq", 4),
         ("hec2x122-none", 2, (1, 2, 2), "hecaton", "none", "seq", 4),
         ("hec2x122-fused", 2, (1, 2, 2), "hecaton", "fused", "seq", 4),
         ("hec4x112-m4", 4, (1, 1, 2), "hecaton", "none", "seq", 4),
         ("hec4x112-m2", 4, (1, 1, 2), "hecaton", "none", "seq", 2),
         ("meg2x12-replicated", 2, (1, 1, 2), "megatron", "none", "replicated", 4))
# tests/_mp/check_pipeline.py's config and run (fp32, grad_reduce fp32, remat none)
NUM = dict(layers=4, d=32, heads=4, kv=2, ff=64, vocab=64, seq=16, batch=8, lr=1e-3,
           warmup=2)
# tests/_mp/check_guard.py's config and run for the runtime and checkpoint replays
RT = dict(layers=2, d=32, heads=4, kv=2, ff=64, vocab=64, seq=16, batch=8, lr=2e-3,
          micro=2, seed=7)
RT_STAGE = (1, 1, 2)
# B2/B3: data B_POISON of B_TOTAL steps; the quorum run: Q_TOTAL steps;
# the cross-package checkpoints: saved at CKPT_STEPS, resumed for as many
B_TOTAL, B_POISON, Q_TOTAL, CKPT_STEPS = 12, (7, 8), 8, 2
