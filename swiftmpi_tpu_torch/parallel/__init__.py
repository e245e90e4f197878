"""Parallelism primitives of the port: the collectives
(``collectives.py``: over the processes of the data axis, and over the
ranks of a named axis on one device), context parallelism
(``ring_attention.py``: ring and Ulysses attention over ``seq``),
pipeline parallelism (``pipeline.py``: GPipe over ``stage``) and expert
parallelism (``moe.py``: routed MoE over ``expert``).  The rank-axis
all-to-alls go through B5 on the card, forward and backward."""

from swiftmpi_tpu_torch.parallel.collectives import (all_gather, all_to_all,
                                                     axis_index, axis_size,
                                                     host_agree, host_psum,
                                                     pmean, psum, psum_many,
                                                     rank_all_to_all,
                                                     rank_pmean, rank_psum,
                                                     rank_reduce_scatter,
                                                     reduce_scatter,
                                                     ring_permute)
from swiftmpi_tpu_torch.parallel.moe import (EXPERT_AXIS, MoEParams,
                                             init_moe_params, moe_ffn,
                                             moe_ffn_reference)
from swiftmpi_tpu_torch.parallel.pipeline import (STAGE_AXIS, pipeline_apply,
                                                  pipeline_loss,
                                                  stack_stage_params)
from swiftmpi_tpu_torch.parallel.ring_attention import (SEQ_AXIS,
                                                        full_attention,
                                                        ring_attention,
                                                        ulysses_attention)

__all__ = ["all_gather", "all_to_all", "axis_index", "axis_size",
           "host_agree", "host_psum", "pmean", "psum", "psum_many",
           "rank_all_to_all", "rank_pmean", "rank_psum",
           "rank_reduce_scatter", "reduce_scatter", "ring_permute",
           "SEQ_AXIS", "full_attention", "ring_attention",
           "ulysses_attention", "STAGE_AXIS", "pipeline_apply",
           "pipeline_loss", "stack_stage_params", "EXPERT_AXIS",
           "MoEParams", "init_moe_params", "moe_ffn", "moe_ffn_reference"]
