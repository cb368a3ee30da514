"""nn.Modules of the port, named after the Flax module tree."""
