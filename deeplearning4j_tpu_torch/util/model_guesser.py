"""ModelGuesser: the port of `deeplearning4j_tpu/util/model_guesser.py` (≡
deeplearning4j-core :: org.deeplearning4j.util.ModelGuesser /
ModelGuesserException).

Loads "whatever model file this is": a DL4J zip archive (MultiLayerNetwork,
then ComputationGraph: `util/model_serializer.py`), in the reference's
order. The JAX package's other branches, a SameDiff graph archive
(`samediff.json` in the zip) and a Keras model file, are not ported yet:
they raise ModelGuesserException naming ROADMAP A17.
"""
from __future__ import annotations

import zipfile

from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

__all__ = ["ModelGuesser", "ModelGuesserException"]


class ModelGuesserException(Exception):
    pass


def _a17(what):
    return ModelGuesserException(
        f"{what}: the SameDiff and Keras front ends are not ported yet; "
        "they come with ROADMAP A17")


class ModelGuesser:
    @staticmethod
    def loadModelGuess(path, device=None):
        """A MultiLayerNetwork or a ComputationGraph on `device` (default:
        the card); raises ModelGuesserException when nothing matches."""
        if not zipfile.is_zipfile(path):
            raise _a17(f"{path!r} is not a DL4J zip archive (a Keras model "
                       "file?)")
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
        if "samediff.json" in names:
            raise _a17(f"{path!r} is a SameDiff graph archive")
        errors = []
        for restore in (ModelSerializer.restoreMultiLayerNetwork,
                        ModelSerializer.restoreComputationGraph):
            try:
                return restore(path, device=device)
            except Exception as e:  # try the next format
                errors.append(f"{restore.__name__}: {e}")
        raise ModelGuesserException(
            f"could not load {path!r} as any known model format: "
            + "; ".join(errors))

    @staticmethod
    def loadNormalizer(path):
        """≡ ModelGuesser.loadNormalizer: the normalizer of a model zip."""
        try:
            return ModelSerializer.restoreNormalizerFromFile(path)
        except Exception as e:
            raise ModelGuesserException(str(e))
