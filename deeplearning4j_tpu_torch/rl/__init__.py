"""RL (≡ rl4j): MDPs, experience replay, sync DQN, batched-env A2C/A3C,
async n-step Q — the port of `deeplearning4j_tpu/rl/`, with its 23 public
names, plus `params_from_numpy` / `params_to_numpy` to carry a learner's
weights across.

The environments, the replay, the history pipeline and every sampling
draw are host numpy, the JAX package's code; the networks and updates run
on the learner's device: the card unless a learner is given
device="cpu"."""
from deeplearning4j_tpu_torch.rl.mdp import (CartpoleNative, DiscreteSpace,
                                             MDP, ObservationSpace,
                                             PixelGridWorld, SimpleToy)
from deeplearning4j_tpu_torch.rl.replay import ExpReplay, Transition
from deeplearning4j_tpu_torch.rl.dqn import (DQNDenseNetworkConfiguration,
                                             DQNFactoryStdDense, DQNPolicy,
                                             EpsGreedy,
                                             QLearningConfiguration,
                                             QLearningDiscreteDense)
from deeplearning4j_tpu_torch.rl.a3c import (A3CConfiguration,
                                             A3CDiscreteConv,
                                             A3CDiscreteDense,
                                             AsyncNStepQLearningDiscreteDense)
from deeplearning4j_tpu_torch.rl.conv import (DQNConvNetworkConfiguration,
                                              DQNFactoryStdConv,
                                              HistoryProcessor,
                                              HistoryProcessorConfiguration,
                                              QLearningDiscreteConv)
from deeplearning4j_tpu_torch.rl.convert import (params_from_numpy,
                                                 params_to_numpy)

__all__ = [
    "CartpoleNative", "DiscreteSpace", "MDP", "ObservationSpace",
    "PixelGridWorld", "SimpleToy", "ExpReplay", "Transition",
    "DQNDenseNetworkConfiguration", "DQNFactoryStdDense", "DQNPolicy",
    "EpsGreedy", "QLearningConfiguration", "QLearningDiscreteDense",
    "A3CConfiguration", "A3CDiscreteConv", "A3CDiscreteDense",
    "AsyncNStepQLearningDiscreteDense",
    "DQNConvNetworkConfiguration", "DQNFactoryStdConv", "HistoryProcessor",
    "HistoryProcessorConfiguration", "QLearningDiscreteConv",
    "params_from_numpy", "params_to_numpy",
]
