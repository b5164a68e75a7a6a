"""Data parallelism across devices (≡ dl4j-examples ::
MultiGpuLenetMnist via ParallelWrapper): the twin of
`examples/distributed_data_parallel.py` on the port.

The port runs one process per device (`torch.distributed`: NCCL on the
card, gloo on the CPU), so the wrapper takes one worker per rank of the
dp world: start the ranks with `torchrun --nproc_per_node=N -m
deeplearning4j_tpu_torch.examples.distributed_data_parallel`, or run it
as one process (a world of one rank). Every rank builds the same net and
reads the same global batches of 64 rows a rank; the wrapper trains on
this rank's rows and averages the gradients over dp. The script prints
`jax.devices()`; the twin prints the world and this rank's device.

`main(device="cpu")` runs it on the CPU."""
import torch.distributed as dist

from deeplearning4j_tpu_torch.datasets.iterators import MnistDataSetIterator
from deeplearning4j_tpu_torch.nn import (Adam, ConvolutionLayer, DenseLayer,
                                         InputType, MultiLayerNetwork,
                                         NeuralNetConfiguration, OutputLayer,
                                         SubsamplingLayer)
from deeplearning4j_tpu_torch.parallel import (ParallelWrapper,
                                               initialize_distributed)


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), dist.get_backend()
    return 1, 0, None


def main(device=None):
    world, rank, backend = _world()
    conf = (NeuralNetConfiguration.Builder()
            .seed(123).updater(Adam(1e-3)).weightInit("xavier")
            .list()
            .layer(ConvolutionLayer(kernelSize=(5, 5), nOut=16,
                                    activation="relu",
                                    convolutionMode="same"))
            .layer(SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(DenseLayer(nOut=128, activation="relu"))
            .layer(OutputLayer(lossFunction="mcxent", nOut=10,
                               activation="softmax"))
            .setInputType(InputType.convolutionalFlat(28, 28, 1))
            .build())
    net = MultiLayerNetwork(conf).init(device)
    print(f"devices: {world} rank(s) ({backend or 'no process group'}); "
          f"rank {rank} on {net._device}")

    # ≡ ParallelWrapper.Builder(model).workers(N)...build()
    wrapper = (ParallelWrapper.Builder(net)
               .workers(world)
               .prefetchBuffer(2)
               .averagingFrequency(1)
               .build())
    wrapper.fit(MnistDataSetIterator(64 * world))
    ev = net.evaluate(MnistDataSetIterator(256, train=False))
    print("accuracy:", ev.accuracy())
    return {"world": world, "rank": rank, "accuracy": float(ev.accuracy()),
            "score": float(net.score())}


if __name__ == "__main__":
    initialize_distributed()
    main()
