"""``python -m pie_tpu_torch.server`` entry point."""

from aiohttp import web

from pie_tpu_torch.server.app import create_app
from pie_tpu_torch.server.config import get_settings


def main():
    settings = get_settings()
    app = create_app(settings=settings)
    web.run_app(app, host=settings.host, port=settings.port)


if __name__ == "__main__":
    main()
