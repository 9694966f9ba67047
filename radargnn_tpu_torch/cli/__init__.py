"""The command-line pipeline: create_dataset, train, evaluate, and main,
which chains the three."""
