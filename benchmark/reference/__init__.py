"""Plain PyTorch references that decide `correct`, one module per model
family, named by a configuration file's `reference` key."""
