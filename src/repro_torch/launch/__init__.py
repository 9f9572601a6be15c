"""Launch layer: the serving steps and the LM serve driver."""
