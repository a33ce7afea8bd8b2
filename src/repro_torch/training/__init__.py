"""Training, scoring and serving steps of the LM stack (port of
``repro/training``): ``optimizer`` (AdamW, the WSD schedule) and
``steps`` (``loss_fn``, ``make_train_step``, prefill and decode)."""
