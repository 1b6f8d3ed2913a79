"""groot_tpu — an accelerator-native resistome profiler.

A from-scratch JAX/XLA rebuild of the capabilities of will-rowe/groot
(GROOT: Graphing Resistance Out Of meTagenomes, Rowe & Winn 2018):

  * variation graphs built from clustered ARG reference sets (MSAs)
  * windowed graph traversals sketched with canonical ntHash MinHash
  * an LSH containment index for read seeding
  * batched exact read↔graph alignment (a hash-join cascade, on the device
    or the host)
  * k-mer weighting / pruning / EM haplotype calling
  * BAM output + coverage-filtered resistome reports

The compute path is JAX (uint32-pair arithmetic, so no process-wide x64);
the host path is NumPy + a small C++ IO runtime. Multi-chip scaling uses
jax.sharding meshes with psum tally merges (see groot_tpu.parallel).
"""

from .version import __version__  # noqa: F401
