"""ModelGuesser: the port of `deeplearning4j_tpu/util/model_guesser.py` (≡
deeplearning4j-core :: org.deeplearning4j.util.ModelGuesser /
ModelGuesserException).

Loads "whatever model file this is", in the reference's order: a zip that
holds `samediff.json` is a SameDiff graph archive (`autodiff/`, either
package's); any other zip is a DL4J archive (MultiLayerNetwork, then
ComputationGraph: `util/model_serializer.py`); anything else is a Keras
file — a whole-model .h5 (architecture in its `model_config` attribute,
weights alongside), else a Keras JSON configuration (Sequential, then
Functional). Every model lands on `device` (the card unless "cpu").
"""
from __future__ import annotations

import zipfile

from deeplearning4j_tpu_torch.util.model_serializer import ModelSerializer

__all__ = ["ModelGuesser", "ModelGuesserException"]


class ModelGuesserException(Exception):
    pass


class ModelGuesser:
    @staticmethod
    def loadModelGuess(path, inputType=None, device=None):
        """A MultiLayerNetwork, a ComputationGraph, a SameDiff or a
        Keras-imported network on `device` (default: the card); raises
        ModelGuesserException when nothing matches."""
        errors = []
        if zipfile.is_zipfile(path):
            with zipfile.ZipFile(path) as zf:
                names = set(zf.namelist())
            if "samediff.json" in names:   # SameDiff full-graph artifact
                from deeplearning4j_tpu_torch.autodiff.samediff import \
                    SameDiff
                try:
                    return SameDiff.load(path, device=device)
                except Exception as e:
                    errors.append(f"samediff: {e}")
            for restore in (ModelSerializer.restoreMultiLayerNetwork,
                            ModelSerializer.restoreComputationGraph):
                try:
                    return restore(path, device=device)
                except Exception as e:  # try the next format
                    errors.append(f"{restore.__name__}: {e}")
        else:
            from deeplearning4j_tpu_torch.keras_import.keras_import import (
                KerasModelImport, is_h5)
            if is_h5(path):
                try:
                    return KerasModelImport.importKerasModelFromH5(
                        path, device=device)
                except Exception as e:
                    errors.append(f"keras h5: {e}")
            else:
                try:
                    return KerasModelImport.\
                        importKerasSequentialModelAndWeights(
                            path, inputType=inputType, device=device)
                except Exception as e:
                    errors.append(f"keras sequential: {e}")
                try:
                    return KerasModelImport.importKerasModelAndWeights(
                        path, device=device)
                except Exception as e:
                    errors.append(f"keras functional: {e}")
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
