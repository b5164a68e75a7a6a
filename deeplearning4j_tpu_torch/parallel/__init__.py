"""Parallel training and inference of the port over `torch.distributed`
(one rank per device): the mesh and its collectives, ring and Ulysses
attention, the pipeline, ZeRO-1, threshold encoding, the sharded and
parameter-averaging trainers, ParallelWrapper, ParallelInference and the
elastic checkpointer. The multi-host half (coordination, membership, the
multi-host trainer and runner, gradient buckets, ElasticTrainer) raises,
naming ROADMAP A15b."""
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


def _a15b(name):
    def raising(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet; it comes with the multi-host half "
            "of parallel/ (ROADMAP A15b)")
    raising.__name__ = name
    return raising


CoordinatedGuardian = _a15b("CoordinatedGuardian")
MultiHostRunner = _a15b("MultiHostRunner")
MultiHostTrainer = _a15b("MultiHostTrainer")
PeerCoordinator = _a15b("PeerCoordinator")
BucketPlan = _a15b("BucketPlan")
check_overlap_structure = _a15b("check_overlap_structure")
plan_buckets = _a15b("plan_buckets")
