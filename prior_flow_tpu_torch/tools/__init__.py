"""The port's measurement tools, run on the card:

    python -m prior_flow_tpu_torch.tools.microbench_vpu_anchor
    python -m prior_flow_tpu_torch.tools.microbench_kernel_split
    python -m prior_flow_tpu_torch.tools.microbench_gridwin

Counterparts of the JAX package's ``tools/microbench_*.py``, with their
TPU kernels replaced by the port's CUDA kernels (``ops/kernels``:
``anchors``, ``dccl_stages``, ``gridwin_variants``). ``chip_smoke.py``
drives the same functions (phases 15-17).
"""
