from .viewer import FrameDrawer, MapDrawer, Viewer  # noqa: F401
