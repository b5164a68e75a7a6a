"""Parallel training and inference of the port over `torch.distributed`
(one rank per device): the mesh and its collectives, ring and Ulysses
attention, the pipeline, ZeRO-1, threshold encoding, the sharded and
parameter-averaging trainers, ParallelWrapper, ParallelInference, the
elastic checkpointer and trainer, and the multi-host half: coordination,
membership, gradient buckets, MultiHostTrainer/MultiHostRunner and the
coordinated guardian."""
from deeplearning4j_tpu_torch.parallel.mesh import (DeviceMesh,
                                                    initialize_distributed)
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
from deeplearning4j_tpu_torch.parallel.sharded_trainer import (
    ParameterAveragingTrainer, ShardedTrainer)
from deeplearning4j_tpu_torch.parallel.ulysses import (
    make_ulysses_attention, ulysses_attention_sharded)
from deeplearning4j_tpu_torch.parallel.ring_attention import (
    blockwise_attention, dense_attention, make_ring_attention,
    ring_attention)
from deeplearning4j_tpu_torch.parallel.buckets import (
    BucketPlan, check_overlap_structure, plan_buckets)
from deeplearning4j_tpu_torch.parallel.compression import (
    encoded_updater, threshold_encoding)
from deeplearning4j_tpu_torch.parallel.elastic import (ElasticCheckpointer,
                                                       ElasticTrainer,
                                                       initialize_multihost)
from deeplearning4j_tpu_torch.parallel.pipeline import (make_pipeline_fn,
                                                        make_pipelined_loss,
                                                        stack_stage_params)
from deeplearning4j_tpu_torch.parallel.zero import (shard_optimizer_state,
                                                    state_memory_bytes)
from deeplearning4j_tpu_torch.parallel.inference import (InferenceMode,
                                                         ParallelInference)
from deeplearning4j_tpu_torch.parallel.multihost import (
    CoordinatedGuardian, MultiHostRunner, MultiHostTrainer, PeerCoordinator)

__all__ = ["DeviceMesh", "initialize_distributed", "ParallelWrapper",
           "ParameterAveragingTrainer", "ShardedTrainer",
           "blockwise_attention", "dense_attention", "make_ring_attention",
           "ring_attention", "make_ulysses_attention",
           "ulysses_attention_sharded", "encoded_updater",
           "threshold_encoding", "BucketPlan", "check_overlap_structure",
           "plan_buckets", "make_pipeline_fn", "make_pipelined_loss",
           "stack_stage_params", "ElasticCheckpointer", "ElasticTrainer",
           "initialize_multihost", "shard_optimizer_state",
           "state_memory_bytes", "InferenceMode", "ParallelInference",
           "CoordinatedGuardian", "MultiHostRunner", "MultiHostTrainer",
           "PeerCoordinator"]
