"""Entry points of the LM zoo: the batched decode engine (``serve``)."""
