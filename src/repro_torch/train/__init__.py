"""Training: AdamW with the WSD schedule (``optim``) and the train step
(``step``)."""
