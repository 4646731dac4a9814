from .engine import ServingEngine
