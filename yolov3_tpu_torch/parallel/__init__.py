"""Train and eval steps of the port, and the data-parallel mesh they run on."""
