"""The port's models, each the counterpart of the JAX package's module of
the same name, imported by module (nothing is imported here):

- `bundle`, `zoo`: weights, the flax bridge and the model repository;
- `resnet`, `vit`, `transformer`, `convnets`: the backbones (AlexNet,
  VGG-11/16 and the CIFAR ConvNet among them) and the TransformerLM;
- `torch_model`, `image_featurizer`: batch inference;
- `generation`: `generate`, `beam_search` and `speculative_generate`;
- `training`: the train state, SGD and Adam, the step and epoch
  factories (with the MoE load-balance loss), `make_distill_epoch`,
  `fit_epochs` and `fit_epochs_resumable`;
- `checkpoint`: verified checkpoints of a `TrainState`;
- `guard`: the training anomaly guard (quarantine, rollback, abort);
- `deep_vision`: `DeepVisionClassifier` / `DeepVisionModel`, with
  `checkpoint_dir`, ragged rows and encoded-bytes inputs;
- `statistics`: `ComputeModelStatistics`, `ComputePerInstanceStatistics`,
  `roc_auc` and `confusion_matrix` (host);
- `linear`: `LogisticRegression` and `LinearRegression` on the card;
- `train_classifier`: `TrainClassifier` / `TrainRegressor` over
  auto-featurized tables;
- `bilstm`: the BiLSTM tagger and `SequenceTagger` / `SequenceTaggerModel`;
- `trainer3d`: the 3D (data x tensor x pipe) LM trainer over a
  `parallel.mesh.MeshPlan`, re-exported by `training`.
"""
