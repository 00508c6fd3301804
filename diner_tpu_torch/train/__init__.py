"""Model construction, the train and eval steps, the YAML config, the
trainer loop with checkpoints and validation, and the training CLI
(``python -m diner_tpu_torch.train``)."""
