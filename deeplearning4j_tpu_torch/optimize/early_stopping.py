"""Early stopping: the port of `deeplearning4j_tpu/optimize/early_stopping.py`
(≡ deeplearning4j-core :: earlystopping.*: EarlyStoppingConfiguration,
EarlyStoppingTrainer, termination conditions, score calculators, model
savers, EarlyStoppingResult).

The trainer drives the network's training step per batch (its CUDA graph
on the card) and evaluates the score calculator every N epochs; best-model
snapshots use net.clone(), which copies the parameter tensors — the live
net's step writes its own in place, so a snapshot sharing them would move
with every later fit() (pinned by test_best_model_survives_further_training).
`LocalFileModelSaver` writes and reads through the port's ModelSerializer
(archives of the JAX package's format). `EarlyStoppingParallelTrainer`
runs each epoch's batches through `parallel.ParallelWrapper`'s dp step.
"""
from __future__ import annotations

import os
import time


class TerminationReason:
    Error = "Error"
    IterationTerminationCondition = "IterationTerminationCondition"
    EpochTerminationCondition = "EpochTerminationCondition"


# ---------------------------------------------------------------- epoch
class MaxEpochsTerminationCondition:
    requires_score = False  # checked every epoch, even non-evaluation ones

    def __init__(self, max_epochs):
        self.max_epochs = int(max_epochs)

    def terminate(self, epoch, score, minimize):
        return epoch + 1 >= self.max_epochs

    def __str__(self):
        return f"MaxEpochsTerminationCondition({self.max_epochs})"


class ScoreImprovementEpochTerminationCondition:
    """Stop after N epochs with no (min-improvement) score gain."""

    def __init__(self, max_epochs_no_improvement, min_improvement=0.0):
        self.max_no_improve = int(max_epochs_no_improvement)
        self.min_improvement = float(min_improvement)
        self._best = None
        self._since = 0

    def initialize(self):
        self._best = None
        self._since = 0

    def terminate(self, epoch, score, minimize):
        if self._best is None:
            self._best = score
            return False
        improved = ((self._best - score) if minimize else (score - self._best)
                    ) > self.min_improvement
        if improved:
            self._best = score
            self._since = 0
        else:
            self._since += 1
        return self._since >= self.max_no_improve

    def __str__(self):
        return (f"ScoreImprovementEpochTerminationCondition("
                f"{self.max_no_improve}, {self.min_improvement})")


class BestScoreEpochTerminationCondition:
    """Stop as soon as the score is better than a target value."""

    def __init__(self, best_expected_score):
        self.target = float(best_expected_score)

    def terminate(self, epoch, score, minimize):
        return score < self.target if minimize else score > self.target

    def __str__(self):
        return f"BestScoreEpochTerminationCondition({self.target})"


# ------------------------------------------------------------- iteration
class MaxTimeIterationTerminationCondition:
    def __init__(self, max_time, unit="s"):
        mult = {"s": 1.0, "sec": 1.0, "seconds": 1.0, "m": 60.0, "min": 60.0,
                "minutes": 60.0, "h": 3600.0, "hours": 3600.0,
                "ms": 1e-3}[str(unit).lower()]
        self.max_seconds = float(max_time) * mult
        self._start = None

    def initialize(self):
        self._start = time.monotonic()

    def terminate(self, score):
        if self._start is None:
            self._start = time.monotonic()
        return time.monotonic() - self._start >= self.max_seconds

    def __str__(self):
        return f"MaxTimeIterationTerminationCondition({self.max_seconds}s)"


class MaxScoreIterationTerminationCondition:
    """Terminate if the per-iteration score exceeds a bound (divergence)."""

    def __init__(self, max_score):
        self.max_score = float(max_score)

    def terminate(self, score):
        return score > self.max_score

    def __str__(self):
        return f"MaxScoreIterationTerminationCondition({self.max_score})"


class InvalidScoreIterationTerminationCondition:
    def terminate(self, score):
        import math
        return math.isnan(score) or math.isinf(score)

    def __str__(self):
        return "InvalidScoreIterationTerminationCondition()"


# -------------------------------------------------------- score calculators
class DataSetLossCalculator:
    """Average (or summed) loss over a validation iterator; minimized."""

    minimize_score = True

    def __init__(self, iterator, average=True):
        self.iterator = iterator
        self.average = bool(average)

    def calculateScore(self, net):
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        total, n = 0.0, 0
        for ds in self.iterator:
            b = int(ds.features.shape[0]) if hasattr(ds.features, "shape") \
                else len(ds.features)
            total += net.score(ds) * b
            n += b
        return total / n if (self.average and n) else total


class ClassificationScoreCalculator:
    """Maximize a classification metric on a validation iterator
    (≡ org.deeplearning4j.earlystopping.scorecalc.ClassificationScoreCalculator).
    metric: 'accuracy' | 'f1' | 'precision' | 'recall'."""

    minimize_score = False

    def __init__(self, metric, iterator):
        self.metric = str(metric).lower()
        self.iterator = iterator

    def calculateScore(self, net):
        e = net.evaluate(self.iterator)
        return {"accuracy": e.accuracy, "f1": e.f1, "precision": e.precision,
                "recall": e.recall}[self.metric]()


class ROCScoreCalculator:
    minimize_score = False

    def __init__(self, iterator):
        self.iterator = iterator

    def calculateScore(self, net):
        return net.evaluateROC(self.iterator).calculateAUC()


# -------------------------------------------------------------- model savers
class InMemoryModelSaver:
    def __init__(self):
        self._best = None
        self._latest = None

    def saveBestModel(self, net, score):
        self._best = (net.clone(), score)

    def saveLatestModel(self, net, score):
        self._latest = (net.clone(), score)

    def getBestModel(self):
        return self._best[0] if self._best else None

    def getLatestModel(self):
        return self._latest[0] if self._latest else None


class LocalFileModelSaver:
    """bestModel.zip / latestModel.zip in `directory`, restored onto
    `device` (default: the card; 'cpu' for the CPU)."""

    def __init__(self, directory, device=None):
        self.directory = str(directory)
        self.device = device
        os.makedirs(self.directory, exist_ok=True)

    def saveBestModel(self, net, score):
        net.save(os.path.join(self.directory, "bestModel.zip"))

    def saveLatestModel(self, net, score):
        net.save(os.path.join(self.directory, "latestModel.zip"))

    def getBestModel(self):
        return self._load("bestModel.zip")

    def getLatestModel(self):
        return self._load("latestModel.zip")

    def _load(self, fname):
        path = os.path.join(self.directory, fname)
        if not os.path.exists(path):
            return None
        from deeplearning4j_tpu_torch.util.model_serializer import \
            ModelSerializer
        return ModelSerializer.restoreModel(path, device=self.device)


# ------------------------------------------------------------- configuration
class EarlyStoppingConfiguration:
    def __init__(self, epoch_conditions, iteration_conditions,
                 score_calculator, model_saver, evaluate_every_n_epochs=1,
                 save_last_model=False):
        self.epoch_conditions = list(epoch_conditions)
        self.iteration_conditions = list(iteration_conditions)
        self.score_calculator = score_calculator
        self.model_saver = model_saver or InMemoryModelSaver()
        self.evaluate_every_n_epochs = int(evaluate_every_n_epochs)
        self.save_last_model = bool(save_last_model)

    class Builder:
        def __init__(self):
            self._epoch = []
            self._iter = []
            self._calc = None
            self._saver = None
            self._every_n = 1
            self._save_last = False

        def epochTerminationConditions(self, *conds):
            if len(conds) == 1 and isinstance(conds[0], (list, tuple)):
                conds = conds[0]
            self._epoch.extend(conds)
            return self

        def iterationTerminationConditions(self, *conds):
            if len(conds) == 1 and isinstance(conds[0], (list, tuple)):
                conds = conds[0]
            self._iter.extend(conds)
            return self

        def scoreCalculator(self, calc):
            self._calc = calc
            return self

        def modelSaver(self, saver):
            self._saver = saver
            return self

        def evaluateEveryNEpochs(self, n):
            self._every_n = int(n)
            return self

        def saveLastModel(self, flag=True):
            self._save_last = bool(flag)
            return self

        def build(self):
            if not self._epoch and not self._iter:
                raise ValueError(
                    "Early stopping needs at least one termination condition "
                    "(epochTerminationConditions / "
                    "iterationTerminationConditions)")
            return EarlyStoppingConfiguration(
                self._epoch, self._iter, self._calc, self._saver,
                self._every_n, self._save_last)


class EarlyStoppingResult:
    def __init__(self, termination_reason, termination_details,
                 score_vs_epoch, best_model_epoch, best_model_score,
                 total_epochs, best_model):
        self.terminationReason = termination_reason
        self.terminationDetails = termination_details
        self.scoreVsEpoch = score_vs_epoch
        self.bestModelEpoch = best_model_epoch
        self.bestModelScore = best_model_score
        self.totalEpochs = total_epochs
        self.bestModel = best_model

    def getTerminationReason(self):
        return self.terminationReason

    def getBestModelEpoch(self):
        return self.bestModelEpoch

    def getBestModelScore(self):
        return self.bestModelScore

    def getTotalEpochs(self):
        return self.totalEpochs

    def getBestModel(self):
        return self.bestModel

    def getScoreVsEpoch(self):
        return self.scoreVsEpoch

    def __str__(self):
        return (f"EarlyStoppingResult(reason={self.terminationReason}, "
                f"details={self.terminationDetails}, "
                f"bestEpoch={self.bestModelEpoch}, "
                f"bestScore={self.bestModelScore}, "
                f"totalEpochs={self.totalEpochs})")


class EarlyStoppingTrainer:
    """Drives fit + periodic scoring until a condition fires
    (≡ earlystopping.trainer.EarlyStoppingTrainer; the Graph variant is the
    same class — both network types share the fit/score surface)."""

    def __init__(self, config, network, train_iterator):
        self.config = config
        self.net = network
        self.train_iterator = train_iterator

    def fit(self):
        cfg = self.config
        for c in cfg.epoch_conditions + cfg.iteration_conditions:
            if hasattr(c, "initialize"):
                c.initialize()

        minimize = (cfg.score_calculator.minimize_score
                    if cfg.score_calculator else True)
        score_vs_epoch = {}
        best_score, best_epoch = None, -1
        epoch = 0
        reason, details = None, None

        while True:
            if hasattr(self.train_iterator, "reset"):
                self.train_iterator.reset()
            for ds in self.train_iterator:
                self.net.fit(ds)
                it_score = self.net.score()
                for c in cfg.iteration_conditions:
                    if c.terminate(it_score):
                        reason = TerminationReason.IterationTerminationCondition
                        details = str(c)
                        break
                if reason:
                    break
            if hasattr(self.net, "_epoch"):
                self.net._epoch += 1
            if reason:
                # keep the "latest" snapshot honest even on mid-epoch
                # iteration-condition termination
                if cfg.save_last_model:
                    cfg.model_saver.saveLatestModel(self.net, self.net.score())
                break

            # score only on evaluation epochs — mixing the training loss
            # into a maximized metric's best-tracking would corrupt it
            is_eval_epoch = (cfg.score_calculator is None
                             or epoch % cfg.evaluate_every_n_epochs == 0)
            if is_eval_epoch:
                if cfg.score_calculator:
                    score = float(
                        cfg.score_calculator.calculateScore(self.net))
                else:
                    score = self.net.score()
                score_vs_epoch[epoch] = score
                improved = (best_score is None
                            or (score < best_score if minimize
                                else score > best_score))
                if improved:
                    best_score, best_epoch = score, epoch
                    cfg.model_saver.saveBestModel(self.net, score)
            # "latest" means every epoch, not every evaluation epoch
            if cfg.save_last_model:
                cfg.model_saver.saveLatestModel(
                    self.net, score_vs_epoch.get(epoch, self.net.score()))

            # score-dependent conditions fire only on evaluation epochs;
            # score-free ones (MaxEpochs) are checked every epoch so they
            # can't overshoot when evaluateEveryNEpochs > 1
            for c in cfg.epoch_conditions:
                if not is_eval_epoch and getattr(c, "requires_score", True):
                    continue
                if c.terminate(epoch, best_score if not is_eval_epoch
                               else score, minimize):
                    reason = TerminationReason.EpochTerminationCondition
                    details = str(c)
                    break
            epoch += 1
            if reason:
                break

        best = cfg.model_saver.getBestModel() or self.net
        return EarlyStoppingResult(
            reason or TerminationReason.Error, details, score_vs_epoch,
            best_epoch, best_score, epoch, best)


# Graph variant shares the implementation (same fit/score surface)
EarlyStoppingGraphTrainer = EarlyStoppingTrainer


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    """≡ deeplearning4j-parallel-wrapper ::
    parallelism.EarlyStoppingParallelTrainer: early stopping over
    data-parallel training. Each batch's fit runs ParallelWrapper's dp
    step (optionally with ZeRO-1 state sharding; every rank of the group
    runs the same trainer), and the scoring and termination loop is
    inherited unchanged."""

    def __init__(self, config, network, train_iterator, workers=None,
                 shard_optimizer_state=False):
        super().__init__(config, network, train_iterator)
        if network._params is None:
            network.init()
        from deeplearning4j_tpu_torch.parallel.wrapper import \
            ParallelWrapper
        self._pw = ParallelWrapper(
            network, workers=workers,
            shard_optimizer_state=shard_optimizer_state)
        self._pw._shard_model()
        # per-DataSet fits go through the wrapper's dp step; every other
        # attribute access, reads and writes, reaches the network itself
        self.net = _DpFitProxy(self._pw)


class _DpFitProxy:
    """Network stand-in whose fit(ds) is ParallelWrapper._fit_dataset;
    everything else (attribute writes like `_epoch += 1` included)
    operates on the wrapped network."""

    def __init__(self, pw):
        object.__setattr__(self, "_pw", pw)

    def fit(self, ds):
        return self._pw._fit_dataset(ds)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_pw").model, name)

    def __setattr__(self, name, value):
        setattr(object.__getattribute__(self, "_pw").model, name, value)
