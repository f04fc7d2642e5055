"""pingoo_tpu_torch: the PyTorch/CUDA port of pingoo_tpu's WAF verdict
engine, for one NVIDIA H100.

It compiles the same rule configs into the same tables as the JAX
package (`pingoo_tpu`, which stays the reference) and evaluates the same
request batches into the same match matrices and action lanes. The
three TPU kernels of the verdict path (the bit-parallel NFA scan, the
bitsplit-DFA walk and the literal prefilter) are CUDA kernels written
for Hopper (`csrc/`), built with nvcc at first use on a CUDA tensor;
each has a plain PyTorch version beside it, which is what runs on CPU
tensors.

Layout (module names follow the JAX package):
  expr/      — the rule expression language and its interpreter (oracle)
  config/    — configuration types and the pingoo.yml loader; lists.py
               loads the CSV lists
  compiler/  — rule AST -> predicate IR -> tables (plan.py)
  ops/       — device ops on tensors; the kernels' Python wrappers
  csrc/      — the CUDA kernel sources
  engine/    — request encoding, the verdict, the batching service, body
               inspection
  native_ring.py — the native plane's shared-memory ring and sidecar
  host/      — the listener's host modules: services and routes,
               discovery, TLS and ACME, captcha and JWT, GeoIP, h2
  obs/       — trace ids, the access log, bounded timing windows
  utils/     — the CRS-style rule corpus and traffic generators

Entry points run on the CUDA card unless given device="cpu".
"""

__version__ = "0.1.0"
