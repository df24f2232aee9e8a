// CPU shim stand-in for <cuda.h>
#pragma once
#include "cuda_shim.h"
