"""The loop kinds a traffic mix names (``"loop": "<kind>"``): each
``loops/<kind>.py`` exports ``Loop``, found by its file name."""
