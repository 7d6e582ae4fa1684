"""Command-line tools of the port: ``make_dataset`` records a training
corpus and evaluation directories, ``export_checkpoint`` writes a model in
the reference's ``.pt`` layout, ``dryrun_multichip`` runs training,
evaluation and search over a ``(data, model)`` mesh of several ranks,
``validate_parity`` holds the port to the reference's inference semantics
(the oracle of ``utils/torch_oracle.py``). Run each as
``python -m dt4image_restoration_tpu_torch.tools.<name>``."""
