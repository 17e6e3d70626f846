"""Training: AdamW with the WSD schedule (``optim``), the train step
(``step``), the training loop with HProt checkpoints and in-transit
analysis (``trainer``) and its restart supervisor (``supervisor``)."""
