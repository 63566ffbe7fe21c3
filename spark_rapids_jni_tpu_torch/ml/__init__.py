"""The ETL→ML handoff.

The port's counterpart of the JAX package's ``ml/``.  Query outputs and
model steps live on the same card in the same process, so a plan's
output lowers straight into training/inference batches with no host
round trip:

* :mod:`.features` — ``FeatureSpec`` maps a plan/table's columns to a
  dense float32 feature matrix on the card (+ optional label vector)
  through the ``rowconv/`` fixed-width pack path.  String columns become
  categorical ids without materializing dictionary bytes; nulls resolve
  through declared imputation policies; every cast happens on the card.
* :mod:`.pipeline` — epoch/batch iterator slicing batches from the
  packed matrix with a deterministic shuffle (the JAX package's, bit for
  bit: :mod:`.prng` carries its threefry2x32 on the host) and no host
  synchronisation in the steady loop.
* :mod:`.train` — the train-step harness (linear/logistic regression,
  SGD/Adam); a fused epoch is one CUDA-graph replay of its whole step
  loop.
* :mod:`.serve` — trained models register as servables; predict requests
  flow through the ``exec/`` scheduler as ``plan → features → predict``,
  and ``stream/`` view refresh doubles as an online feature store.
"""

from .features import (Feature, FeatureBatch, FeatureSpec,  # noqa: F401
                       compile_feature_plan)
from .pipeline import BatchPipeline                          # noqa: F401
from .train import (Trainer, TrainResult, adam,              # noqa: F401
                    linear_regression, logistic_regression,
                    params_from_numpy, params_to_numpy, sgd)
from .serve import (FeatureView, ServableModel,              # noqa: F401
                    get_servable, register_servable, servables)
