"""Graph construction, features and padded batches."""
