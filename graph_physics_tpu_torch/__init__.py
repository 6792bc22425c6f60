"""PyTorch / CUDA port of graph_physics_tpu for one NVIDIA H100.

The layout mirrors ``graph_physics_tpu`` (``core/``, ``dataset/``,
``models/``, ``ops/``, ``training/``, ``utils/``) so each module's
counterpart is easy to find. The package imports torch, numpy and scipy
only: never jax, flax or ``graph_physics_tpu`` itself, so it runs on a
machine that has no JAX installed. The hand-written Hopper kernels live
under ``csrc/`` and are built at first use (``ops/fused_gnblock_nk.py``).

``entry.py`` builds each ported path on synthetic data; the train ->
predict loop (``dataset/`` loader, ``training/trainer.py``, checkpoints,
``cli/train.py`` and ``cli/predict.py``) takes the JAX package's two-JSON
configs. ROADMAP.md lists what is still to port.
"""
