"""audiosourcesep_tpu — a JAX framework for audio source separation.

A ground-up rebuild of the capabilities of SamArgt/AudioSourceSep (TF2/TFP
research code) as an XLA-compiled framework:

* deep generative priors over mel-spectrogram patches — Glow / RealNVP /
  Flow++ normalizing flows (``audiosourcesep_tpu.bijectors``,
  ``audiosourcesep_tpu.models``) and NCSN v1/v2 score networks
  (``audiosourcesep_tpu.models.ncsn``);
* BASIS separation (annealed Langevin dynamics constrained by a mixture)
  as a single jitted ``lax.scan`` (``audiosourcesep_tpu.separation``);
* an XLA-native audio front-end — batched STFT, mel filterbanks,
  Griffin-Lim, NNLS mel inversion (``audiosourcesep_tpu.ops``);
* data pipeline with TFRecord-compatible IO (``audiosourcesep_tpu.data``);
* SPMD data parallelism over a ``jax.sharding.Mesh``
  (``audiosourcesep_tpu.parallel``);
* BSS-Eval v4 metrics and oracle systems (``audiosourcesep_tpu.evaluation``).

Everything on the compute path is pure-functional JAX: params are explicit
pytrees, loops are ``lax.scan``, and models compile once under ``jax.jit``.
"""

__version__ = "0.1.0"

import os as _os

# Persistent XLA compilation cache at a fixed path in the checkout: the
# path is part of the cache key, so a directory that moves never hits.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def _enable_compilation_cache() -> None:
    """Point JAX's persistent compilation cache at :data:`CACHE_DIR`,
    unless ``JAX_COMPILATION_CACHE_DIR`` is set: JAX reads that variable
    itself, and the program then sets no directory of its own."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax as _jax
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


_enable_compilation_cache()
