"""Entry points of the port's LM path (counterpart of `repro.launch`)."""
