"""Mix2FLD core of the port: losses, Mixup / inverse-Mixup, seed
collection, the eq. (5) conversion and the protocol round loop."""
