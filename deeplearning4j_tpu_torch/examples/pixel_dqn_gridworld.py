"""Pixel-input DQN (≡ rl4j-examples :: ALE/A3C ALE pixel agents, scaled
to a zero-egress synthetic env): the twin of
`examples/pixel_dqn_gridworld.py` on the port — HistoryProcessor frame
pipeline + conv Q-network + frame skip on a rendered grid world, the
script's settings and its `play > 0.9` check.

Run: `python -m deeplearning4j_tpu_torch.examples.pixel_dqn_gridworld`
(the card; `main(device="cpu")` runs it on the CPU)."""
from deeplearning4j_tpu_torch.rl import (DQNConvNetworkConfiguration,
                                         HistoryProcessorConfiguration,
                                         PixelGridWorld,
                                         QLearningConfiguration,
                                         QLearningDiscreteConv)


def main(device=None):
    mdp = PixelGridWorld(size=6, scale=2, maxSteps=30)
    learner = QLearningDiscreteConv(
        mdp,
        DQNConvNetworkConfiguration(learningRate=1e-3, filters=(8,),
                                    kernels=((3, 3),), strides=((2, 2),),
                                    denseUnits=32),
        HistoryProcessorConfiguration(historyLength=2, rescaledWidth=12,
                                      rescaledHeight=12, skipFrame=1),
        QLearningConfiguration(seed=1, maxEpochStep=30, maxStep=600,
                               expRepMaxSize=5000, batchSize=16,
                               targetDqnUpdateFreq=50, updateStart=20,
                               gamma=0.95, minEpsilon=0.05,
                               epsilonNbStep=300),
        device=device)
    rewards = learner.train()
    print(f"episodes: {len(rewards)}; "
          f"last-5 rewards: {[round(r, 2) for r in rewards[-5:]]}")
    play = learner.getPolicy().play(PixelGridWorld(size=6, scale=2,
                                                   maxSteps=30))
    print(f"greedy play reward: {play:.2f} (optimal 0.96)")
    if not play > 0.9:
        raise AssertionError(f"pixel DQN: greedy play {play} <= 0.9")
    return {"episodes": len(rewards), "last5": rewards[-5:], "play": play}


if __name__ == "__main__":
    main()
