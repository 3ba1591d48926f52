"""OpenAI-compatible HTTP serving layer (aiohttp), single-stream engine."""

from pie_tpu_torch.server.app import create_app
