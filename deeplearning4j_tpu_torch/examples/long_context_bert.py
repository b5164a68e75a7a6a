"""Long-sequence BERT training: ring attention over the sequence axis +
per-layer rematerialization + ZeRO-1 state sharding in one step — the
twin of `examples/long_context_bert.py` on the port.

The three memory levers compose:
- sp (sequence parallel): each rank holds T/sp of the sequence; the ring
  passes K/V shards from rank to rank (`parallel/ring_attention.py`: on
  the card the flash kernels, B1 forward and B2a/B2b backward, on each
  held block), so no rank materializes the full (T, T) score matrix.
- remat: encoder layers recompute activations in the backward
  (`bert_tiny(remat=True)`).
- ZeRO-1: Adam moments shard over dp (`parallel/zero.py`).

The port runs one process per device (torchrun, or any process group);
`ShardedTrainer` is the step the script jits. The script takes dp = 2 and
sp = devices / 2; the twin takes the same from the port's world when it
has at least 4 ranks, and otherwise dp = 1 and sp = world (one rank on
one card: sp = 1, T = 64). Its weights come from the port's generator
(the script's from `PRNGKey(0)`), so its losses are not the script's.

Run: `torchrun --nproc_per_node=N -m
deeplearning4j_tpu_torch.examples.long_context_bert`, or as one process
(the card; `main(device="cpu")` runs it on the CPU)."""
import numpy as np
import torch.distributed as dist

from deeplearning4j_tpu_torch.device import resolve
from deeplearning4j_tpu_torch.models.bert import (bert_tiny,
                                                  classification_loss,
                                                  sharding_rules)
from deeplearning4j_tpu_torch.models.convert import init_bert_params
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.parallel import (ShardedTrainer,
                                               initialize_distributed,
                                               make_ring_attention)
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh, P, shard_map
from deeplearning4j_tpu_torch.parallel.zero import shard_optimizer_state


def mesh_shape(world):
    """(dp, sp) for a world of `world` ranks."""
    if world >= 4:
        return 2, world // 2
    return 1, world


def main(device=None):
    resolve(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    dp, sp = mesh_shape(world)
    mesh = DeviceMesh(device=device, dp=dp, sp=sp)
    T = 64 * sp   # sequence length scales with the sp axis
    B = 2 * dp

    cfg = bert_tiny(max_position_embeddings=T, remat=True)
    params = init_bert_params(cfg, 0, device=mesh.device)
    spec = P(None, None, "sp", None)
    ring = shard_map(make_ring_attention(mesh, "sp"), mesh=mesh,
                     in_specs=(spec, spec, spec), out_specs=spec,
                     check_vma=False)

    def loss_fn(p, batch, generator):
        return classification_loss(cfg, p, batch, train=False,
                                   attn_impl=ring)

    trainer = ShardedTrainer(loss_fn, Adam(1e-4), mesh,
                             sharding_rules(cfg, mesh, dp="dp", tp=None))
    p, opt_state = trainer.init(params)
    opt_state = shard_optimizer_state(opt_state, mesh, axis="dp")

    rng = np.random.default_rng(0)
    batch = trainer.shard_batch({
        "input_ids": rng.integers(0, cfg.vocab_size, (B, T)),
        "labels": rng.integers(0, cfg.num_labels, (B,))})
    losses = []
    for step in range(3):
        p, opt_state, loss = trainer.fit_batch(p, opt_state, batch)
        losses.append(float(loss))
        print(f"step {step}: T={T} loss={losses[-1]:.4f}")
    return {"dp": dp, "sp": sp, "T": T, "losses": losses}


if __name__ == "__main__":
    initialize_distributed()
    main()
