"""Train and eval steps of the port (one device)."""
