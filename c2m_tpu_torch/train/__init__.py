"""Train state and train step of the port."""
