"""The port's models, each the counterpart of the JAX package's module of
the same name, imported by module (nothing is imported here):

- `bundle`, `zoo`: weights, the flax bridge and the model repository;
- `resnet`, `vit`, `transformer`: the backbones and the TransformerLM;
- `torch_model`, `image_featurizer`: batch inference;
- `generation`: `generate`;
- `training`: the train state, SGD and Adam, the step and epoch
  factories, `fit_epochs` and `fit_epochs_resumable`;
- `checkpoint`: verified checkpoints of a `TrainState`;
- `guard`: the training anomaly guard (quarantine, rollback, abort);
- `deep_vision`: `DeepVisionClassifier` / `DeepVisionModel`, with
  `checkpoint_dir`, ragged rows and encoded-bytes inputs.

Not ported yet (ROADMAP): `make_distill_epoch` and the MoE auxiliary
loss (A14), the `models/convnets.py` backbones, `linear.py` and
`train_classifier.py` (A17), the 3D trainer and elastic resume (A19).
"""
