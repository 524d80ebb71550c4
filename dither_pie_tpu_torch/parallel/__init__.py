"""Work split across hosts: ``multihost.py`` strides a video's segment grid
and a folder's file list over hosts that share a filesystem."""
