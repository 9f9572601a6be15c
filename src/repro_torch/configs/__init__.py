"""Model configurations.  Only the paper CNN's constants are ported; the
``ArchConfig`` registry waits for the LM slice of the port."""
