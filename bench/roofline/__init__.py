"""Operation and byte counts per layer, and the published peaks."""
