"""Run-time support of the port: failure handling and straggler
mitigation (`fault`)."""
