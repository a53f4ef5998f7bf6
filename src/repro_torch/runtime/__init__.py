"""Run-time support of the port: failure handling and straggler
mitigation (`fault`), re-meshing onto other ranks (`elastic`)."""
