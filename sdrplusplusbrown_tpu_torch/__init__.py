"""PyTorch/CUDA port of sdrplusplusbrown_tpu.

Same block contract as the JAX package — ``y, state' = block.apply(params,
state, x)`` with explicit carried state (dicts of tensors keyed, shaped and
typed like the JAX package's) and static block lengths set by
``in_multiple`` — running on PyTorch tensors.  On a CUDA tensor every
kernel-backed stage launches its hand-written Hopper kernel
(``csrc/*.cu``, built at first use by ``kernels/_build.py``) or raises; on a
CPU tensor it runs the plain PyTorch version beside the kernel.

Ported so far: ``models.radio.Radio`` (WFM, NFM, AM, SSB, DSB, CW) through
``apply``, ``apply_shared`` and ``apply_channelized``, ``RadioBank``,
``PolyphaseChannelizer``, and the headless app served over HTTP:
``python -m sdrplusplusbrown_tpu_torch`` (``app.SDRApp``).
"""
