"""Word2Vec on a text corpus (≡ dl4j-examples :: Word2VecRawTextExample):
the twin of `examples/word2vec_text.py` on the port.

One setting differs: the learning rate. The skip-gram step sums its
gradient over the pairs of a batch (per-pair learning-rate semantics), and
with 12 words in batches of 1024 pairs a row's summed step at the
script's 0.05 overflows: the script prints nan similarities. The twin
runs at 0.005, where they stay finite.

Run: `python -m deeplearning4j_tpu_torch.examples.word2vec_text` (the
card; `main(device="cpu")` runs it on the CPU)."""
import numpy as np

from deeplearning4j_tpu_torch.nlp import (CollectionSentenceIterator,
                                          CommonPreprocessor,
                                          DefaultTokenizerFactory, Word2Vec)

# two topics whose words co-occur within-topic but never across — skip-gram
# places words with similar CONTEXTS near each other
_TIME = ["day", "night", "morning", "evening", "noon", "dusk"]
_SKY = ["sun", "moon", "stars", "clouds", "comet", "nebula"]
_rng = np.random.default_rng(7)
SENTENCES = ["{} {} {} {} {} {}".format(
    *_rng.choice(fam, 6)) for _ in range(300)
    for fam in (_TIME if _rng.random() < 0.5 else _SKY,)]


def main(device=None):
    tok = DefaultTokenizerFactory()
    tok.setTokenPreProcessor(CommonPreprocessor())
    vec = (Word2Vec.Builder()
           .minWordFrequency(2)
           .layerSize(32)
           .seed(42)
           .windowSize(3)
           .learningRate(0.005)
           .epochs(20)
           .sampling(0)  # tiny corpus: keep every token
           .iterate(CollectionSentenceIterator(SENTENCES))
           .tokenizerFactory(tok)
           .device(device)
           .build()
           .fit())
    out = {"vocab": vec.vocabSize(),
           "nearest_day": vec.wordsNearest("day", 5),
           "sim_day_night": vec.similarity("day", "night"),
           "sim_day_stars": vec.similarity("day", "stars")}
    print("vocab:", out["vocab"])
    print("closest to 'day':", out["nearest_day"])
    print("sim(day, night) =", out["sim_day_night"])
    print("sim(day, stars) =", out["sim_day_stars"])
    return out


if __name__ == "__main__":
    main()
