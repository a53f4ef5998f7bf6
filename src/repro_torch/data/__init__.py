"""The token pipeline of the training path (`pipeline`)."""
