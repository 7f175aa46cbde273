"""WSGI entry point of the port's web service.

``gunicorn acai_omr_tpu_torch.wsgi:app`` serves the Flask app when Flask is
installed, else the dependency-free WSGI application, with the same routes
and the same switches (``ACAI_DYNAMIC_BATCHING`` and the others of
:mod:`.serving.app`) either way.
"""

try:
    from acai_omr_tpu_torch.serving.app import create_app
    app = create_app()  # create_app honours ACAI_DYNAMIC_BATCHING itself
except ModuleNotFoundError:
    from acai_omr_tpu_torch.serving.app import batching_from_env
    from acai_omr_tpu_torch.serving.wsgi_app import application as app
    batching_from_env()
