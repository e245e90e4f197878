"""Parallelism primitives of the port: the data axis's collectives
(``collectives.py``).  The JAX package's ring attention, MoE and pipeline
parallelism are ROADMAP A15."""

from swiftmpi_tpu_torch.parallel.collectives import (all_gather, all_to_all,
                                                     axis_index, axis_size,
                                                     host_agree, host_psum,
                                                     psum, psum_many)

__all__ = ["all_gather", "all_to_all", "axis_index", "axis_size",
           "host_agree", "host_psum", "psum", "psum_many"]
