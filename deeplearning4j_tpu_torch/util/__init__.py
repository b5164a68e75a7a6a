"""Utilities of the port: `crash_reporting` (the OOM crash dump), `serde`
(the configuration JSON), `model_serializer` (the model archives) and
`model_guesser`."""
