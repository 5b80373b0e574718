"""Hand-written CUDA kernels for Hopper (sm_90a).

Each kernel ships as <name>/{kernel.py, ops.py, ref.py, csrc/*.cu}:
  csrc/*.cu — the CUDA C++ source, plain C interface
  kernel.py — ctypes wrapper: checks, output allocation, launch, counter
  ops.py    — ``impl`` dispatch between the kernel and its plain version
  ref.py    — the plain PyTorch version the kernel is held against

gwf_waterfill   — the paper's water-filling bisections: the batched
                  generic (shared regular family) and hetero (per-job
                  families) CAP kernels, and the single-instance level WFP.
flash_attention — forward online-softmax attention (GQA/MQA, causal,
                  sliding window, softcap): the prefill attention of the
                  model stack.
linear_scan     — the diagonal recurrence h_t = a_t·h_{t−1} + b_t: the
                  RG-LRU prefill scan.
Sources are built with nvcc on first use (``_build.py``).
"""
