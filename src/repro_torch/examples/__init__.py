"""Examples of the port (mirrors ``examples/``): ``federated_llm``."""
