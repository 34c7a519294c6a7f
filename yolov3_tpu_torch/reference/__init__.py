"""Plain PyTorch references of models the port serves, written from their
published equations and importing nothing of the port: the tests hold the
port's forward and decode to them."""
