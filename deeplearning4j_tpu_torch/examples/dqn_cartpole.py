"""DQN on CartPole (≡ rl4j-examples :: Cartpole DQN example): the twin of
`examples/dqn_cartpole.py` on the port, at the script's settings.

`maxStep` (the script's 12,000) is a keyword so a quick check can run
fewer steps; the Q-network draws from the port's generator, so its
rewards are not the JAX script's.

Run: `python -m deeplearning4j_tpu_torch.examples.dqn_cartpole` (the
card; `main(device="cpu")` runs it on the CPU)."""
from deeplearning4j_tpu_torch.rl import (CartpoleNative,
                                         DQNDenseNetworkConfiguration,
                                         QLearningConfiguration,
                                         QLearningDiscreteDense)


def main(device=None, maxStep=12000):
    conf = QLearningConfiguration(
        seed=123, maxEpochStep=200, maxStep=maxStep, expRepMaxSize=10000,
        batchSize=64, targetDqnUpdateFreq=200, updateStart=128,
        gamma=0.99, minEpsilon=0.05, epsilonNbStep=6000)
    dqn = QLearningDiscreteDense(
        CartpoleNative(seed=0),
        DQNDenseNetworkConfiguration(numLayers=2, numHiddenNodes=64,
                                     learningRate=1e-3),
        conf, device=device)
    rewards = dqn.train()
    recent = rewards[-10:]
    out = {"episodes": len(rewards),
           "last10_mean": sum(recent) / len(recent),
           "play": dqn.getPolicy().play(CartpoleNative(seed=99)),
           "steps": dqn.step_count, "updates": dqn.updates}
    print(f"episodes: {out['episodes']}; last-10 mean reward: "
          f"{out['last10_mean']:.1f}")
    print("greedy play:", out["play"])
    return out


if __name__ == "__main__":
    main()
