__version__ = "0.3.15"
__version_major__ = 0
__version_minor__ = 3
__version_patch__ = 15
