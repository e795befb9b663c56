"""The viewer's host layer in C++ (camera controls and the properties
parser), bound with ctypes: native/binding.py."""
