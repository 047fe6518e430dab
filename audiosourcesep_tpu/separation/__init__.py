from .mixing import mixing_process
from .basis import (BasisConfig, basis_separate, basis_separate_per_level,
                    glow_score_fn, make_level_program,
                    make_stacked_ncsn_score, ncsn_score_fn,
                    source_sharded_glow_score,
                    source_sharded_ncsn_score,
                    postprocess, preprocess_mixture, stack_pytrees)

__all__ = [
    "mixing_process", "BasisConfig", "basis_separate",
    "basis_separate_per_level", "make_level_program", "ncsn_score_fn",
    "glow_score_fn",
    "make_stacked_ncsn_score", "source_sharded_ncsn_score",
    "source_sharded_glow_score", "postprocess",
    "preprocess_mixture", "stack_pytrees",
]
