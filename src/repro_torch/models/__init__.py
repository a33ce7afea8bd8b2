"""The LM stack of the port (``repro/models``): the dense GQA family."""
