"""The optimizer (`adamw`) and error-feedback gradient compression
(`compression`) of the training path."""
